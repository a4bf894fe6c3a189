"""A rounding witness for the CPU's fp32 convolutions: the same sums taken
in another order.

The model's activations and most conv weights are channels-last. On the
CPU, PyTorch hands a channels-last fp32 convolution to oneDNN's brgemm
kernel, whose sums carry about four times the rounding of its NCHW
(blocked direct) kernel: against a float64 reference, a 256->192 3x3 conv
at 16x16 errs by 8.4e-7 RMS relative where the NCHW kernel errs by
2.2e-7. Under :func:`nchw_conv_order` every ``F.conv2d`` (and its
backward) sums as the NCHW kernel does, on NCHW copies of its operands,
and returns its output in the layout the model gave it, so every other op
runs as in the model.

Tests do not run the model under it. They run the model as it is and,
where two computations of the same step differ only in how their convs
are summed (a band against the whole image), take the gap that this
other summation order opens in the same step as the measure of rounding.
"""

import contextlib

import torch
import torch.nn.functional as F

CL = torch.channels_last


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=CL))


@contextlib.contextmanager
def nchw_conv_order():
    conv2d = F.conv2d

    def conv(x, w, *args, **kwargs):
        y = conv2d(x.clone(memory_format=torch.contiguous_format),
                   w.clone(memory_format=torch.contiguous_format),
                   *args, **kwargs)
        if _channels_last(x) or _channels_last(w):
            y = y.contiguous(memory_format=CL)
        return y

    F.conv2d = conv
    try:
        yield
    finally:
        F.conv2d = conv2d
