"""Device kernels a served request runs (the graph's replay and the
harness's copies that are kernels, not the upload and readback), counted
in the traced window over its requests."""


def read(view):
    if view.units <= 0 or view.kernel_launches <= 0:
        return None
    return view.kernel_launches / view.units
