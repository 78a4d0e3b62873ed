"""The plain references against the port's plain path at a tiny size,
in float32 on the CPU, with the benchmark's weights loaded into both."""

import torch
import torch.nn.functional as F

from gpubench.conftest import TINY_CNN, TINY_LM
from gpubench.programs import build_model
from gpubench.reference import cnn as ref_cnn
from gpubench.reference import lm as ref_lm
from gpubench.reference.precision import FP8
from gpubench.weights import cnn_specs, lm_specs, make_flat, views

CPU = torch.device("cpu")


def test_lm_logits_and_gradients_match_the_port():
    specs = lm_specs(TINY_LM)
    flat = make_flat(specs, 2**31 + 3, CPU)
    model = build_model(TINY_LM, views(flat, specs), CPU)
    tokens = torch.randint(0, TINY_LM["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(1))
    out = model(tokens)
    w = views(flat.clone().requires_grad_(), specs)
    ref = ref_lm.logits(w, tokens, TINY_LM)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # the objective and its gradient, leaf by leaf
    loss = F.cross_entropy(out[:, :-1].reshape(-1, out.shape[-1]),
                           tokens[:, 1:].reshape(-1), reduction="sum")
    loss.backward()
    wf = flat.clone().requires_grad_()
    ref_sum, count = ref_lm.loss_sum(views(wf, specs), tokens, TINY_LM)
    ref_sum.backward()
    assert count == 2 * 23
    torch.testing.assert_close(loss, ref_sum, rtol=1e-5, atol=1e-5)
    grads = views(wf.grad, specs)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], rtol=1e-4,
                                   atol=1e-5, msg=name)


def test_cnn_logits_match_the_port():
    specs = cnn_specs(TINY_CNN)
    flat = make_flat(specs, 5, CPU)
    model = build_model(TINY_CNN, views(flat, specs), CPU)
    x = torch.randn((6, 8, 8, 3), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(model(x),
                               ref_cnn.logits(views(flat, specs), x,
                                              TINY_CNN),
                               rtol=1e-5, atol=1e-5)


def test_fp8_control_departs_from_the_reference():
    specs = lm_specs(TINY_LM)
    w = views(make_flat(specs, 9, CPU), specs)
    tokens = torch.randint(0, 64, (1, 16),
                           generator=torch.Generator().manual_seed(3))
    exact = ref_lm.logits(w, tokens, TINY_LM)
    low = ref_lm.logits(w, tokens, TINY_LM, FP8)
    gap = (exact - low).abs().max()
    assert 1e-3 < gap < 1.0
