"""Plain reference of the CIFAR-10 CNN.

NHWC input; for each width two 3x3 convolutions ('SAME' padding,
``[3, 3, Cin, Cout]`` kernels, cross-correlation) each followed by
ReLU, then a 2x2 max-pool; flatten in (h, w, c) order; Dense(dense) +
ReLU; Dense(num_classes). The objective is the categorical
cross-entropy against one-hot labels, averaged over the batch. Weights
are ``gpubench.weights.cnn_specs`` leaves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference.precision import F32


def _conv(x, kernel, bias, prec):
    # a convolution is a matrix product: its operands take the
    # precision's rounding like the dense layers'
    return prec.result(F.conv2d(prec.operand(x),
                                prec.operand(kernel).permute(3, 2, 0, 1),
                                bias, padding=1))


def logits(w, x, cfg, prec=F32):
    """``[b, num_classes]`` logits of NHWC images ``x``."""
    h = x.to(torch.float32).permute(0, 3, 1, 2)
    i = 0
    for _ in cfg["widths"]:
        for _ in range(2):
            h = F.relu(_conv(h, w[f"Conv_{i}.kernel"], w[f"Conv_{i}.bias"],
                             prec))
            i += 1
        h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(prec.mm(h, w["Dense_0.kernel"]) + w["Dense_0.bias"])
    return prec.mm(h, w["Dense_1.kernel"]) + w["Dense_1.bias"]


def loss_sum(w, x, y, cfg, prec=F32):
    """Summed cross-entropy of a block of rows, and its row count."""
    out = logits(w, x, cfg, prec)
    return -(y * F.log_softmax(out, dim=-1)).sum(), x.shape[0]
