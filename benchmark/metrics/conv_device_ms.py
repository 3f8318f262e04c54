"""Device ms per step of the convolutions (forward, input gradient and
weight gradient, cuDNN's and any other kernel they launch): the device
time of every activity whose launching operation is a convolution, over
the traced window's steps."""

#: the operations that launch a convolution's kernels
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward", "aten::_convolution",
            "aten::convolution", "aten::conv1d", "aten::conv_transpose1d",
            "aten::_convolution_mode")


def read(rec):
    seconds = rec.trace.device_seconds(lambda a: a.op in CONV_OPS)
    if not seconds or not rec.units:
        return None
    return seconds / rec.units * 1e3
