"""Device kernels a training step runs (mixup, forward, backward,
optimizer), counted in the traced window over its steps."""


def read(view):
    if view.units <= 0 or view.kernel_launches <= 0:
        return None
    return view.kernel_launches / view.units
