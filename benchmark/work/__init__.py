"""Work counts from the configuration's shapes alone: each kernel's bytes
and operations a launch (``<kernel>.py``) and each model family's
operations an image (``<family>.py``). They count what the algorithm
needs, never how a kernel implements it."""
