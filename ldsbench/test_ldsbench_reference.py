"""The plain references against the program's own forward at a tiny size
on the CPU (float32), which shows the references right; the fp8 control
and the nucleus edge the check reads."""
import dataclasses
import math

import pytest
import torch

from ldsbench.families import dense, ssd
from ldsbench.harness import draw_kept, kept_edge
from ldsbench.reference import dense as ref_dense
from ldsbench.reference import ssd as ref_ssd


def tiny(name):
    from repro_torch.configs import get_config

    return get_config(name).reduced()


@pytest.mark.parametrize("name,family,ref", [
    ("granite-8b", dense, ref_dense), ("mamba2-1.3b", ssd, ref_ssd)])
@pytest.mark.parametrize("length", [7, 70])
def test_reference_matches_the_program(name, family, ref, length):
    from repro_torch.models import forward

    cfg = tiny(name)
    c = dataclasses.asdict(cfg)
    params = family.make_weights(c, 3, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (1, length),
                           generator=torch.Generator().manual_seed(length))
    with torch.no_grad():
        want, _ = forward(cfg, params, tokens)
    got = ref.logits_at(c, params, [tokens[0]], [(0, length)])[0]
    scale = want.abs().max()
    assert float((got - want[0]).abs().max() / scale) < 2e-5


@pytest.mark.parametrize("name,family,ref", [
    ("granite-8b", dense, ref_dense), ("mamba2-1.3b", ssd, ref_ssd)])
def test_fp8_control_departs(name, family, ref):
    cfg = tiny(name)
    c = dataclasses.asdict(cfg)
    params = family.make_weights(c, 4, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(1))
    full = ref.logits_at(c, params, [tokens], [(0, 40)])[0]
    low = ref.logits_at(c, params, [tokens], [(0, 40)], precision="fp8")[0]
    rel = float((low - full).abs().max() / full.abs().max())
    assert 1e-3 < rel < 0.5


def test_ssd_dual_form_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 37, 3, 4, 5
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.2
    A = -torch.rand(h, generator=g) * 4 - 0.5
    B, C = torch.randn(s, n, generator=g), torch.randn(s, n, generator=g)
    D = torch.randn(h, generator=g)
    y = ref_ssd.ssd(x, dt, A, B, C, D)
    state = torch.zeros(h, p, n)
    for t in range(s):
        state = (state * torch.exp(dt[t] * A)[:, None, None]
                 + (x[t] * dt[t][:, None])[..., None] * B[t])
        want = state @ C[t] + D[:, None] * x[t]
        assert torch.allclose(y[t], want, atol=1e-5, rtol=1e-5)


def test_kept_edge_is_the_programs_nucleus():
    from repro_torch.kernels.plain import process_logits

    g = torch.Generator().manual_seed(2)
    logits = torch.randn(6, 500, generator=g) * 3
    samp = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
    kept = process_logits(logits, torch.full((6,), 0.8),
                          torch.full((6,), 50), torch.full((6,), 0.95))
    want = torch.where(torch.isinf(kept), math.inf, kept).amin(dim=-1)
    assert torch.allclose(kept_edge(logits, samp), want)


def test_draw_kept_stays_in_the_set():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(64, 300, generator=g) * 3
    samp = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
    tok = draw_kept(logits, samp, torch.Generator().manual_seed(4))
    x = logits.gather(1, tok[:, None])[:, 0] / 0.8
    assert bool((x >= kept_edge(logits, samp)).all())
    assert len(set(tok.tolist())) > 1
