"""What the work costs, counted from shapes and data, never from the
program: the model's operations (``flops``), each kernel's least bytes and
operations (``kernels``) and the chip's peaks."""
