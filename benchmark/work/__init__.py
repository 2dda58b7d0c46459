"""The work a cell's step or sampler call needs, from its shapes: model
FLOPs (`flops.py`), the FIR resamples and gated 3x3 convs with their
roofline bounds (`kernels.py`), and the peaks they are held to
(`peaks.py`). Everything here runs the plain reference on the meta device;
nothing reads the program."""
