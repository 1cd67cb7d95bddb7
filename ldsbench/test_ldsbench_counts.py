"""The operation and byte counts at hand-worked shapes, and the weight
makers against the program's parameter layout."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from ldsbench import peaks
from ldsbench.families import dense, ssd

CONFIGS = Path(__file__).resolve().parent / "configs"


def arch(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["arch"]


def test_granite_counts_by_hand():
    c = arch("granite-8b")
    # per layer: q 4096x4096, k and v 4096x1024, o 4096x4096, MLP 3x4096x14336
    per_layer = 16_777_216 + 2 * 4_194_304 + 16_777_216 + 176_160_768
    assert dense.matmul_weights(c) == 36 * per_layer + 4096 * 49152
    assert dense.matmul_weights(c) == 8_053_063_680
    # one token at position 0 attends one position: 36 x 4 x 32 x 128
    assert dense.token_flops(c, 0, 1) == 2 * 8_053_063_680 + 589_824
    # positions 2, 3, 4 attend 3 + 4 + 5 = 12 positions
    assert dense.token_flops(c, 2, 5) == (3 * 2 * 8_053_063_680
                                          + 12 * 589_824)
    nbytes, flops = dense.paged_decode_cost(c, [100, 200])
    assert nbytes == (300 * 2 * 1024 + 2 * 2 * 4096) * 2
    assert flops == 300 * 4 * 32 * 128


def test_mamba2_counts_by_hand():
    c = arch("mamba2-1.3b")
    per_layer = 2048 * (8192 + 256 + 64) + 4096 * 2048
    assert ssd.matmul_weights(c) == 48 * per_layer + 2048 * 50280
    extra = 2 * 4 * (4096 + 256) + 5 * 64 * 64 * 128 + 2 * 64 * 64
    assert ssd.token_flops(c, 5, 6) == 2 * 1_342_390_272 + 48 * extra
    assert ssd.token_flops(c, 0, 10) == 10 * ssd.token_flops(c, 3, 4)


def test_bound_picks_the_larger_side():
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 989e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,family", [("granite-8b", dense),
                                         ("mamba2-1.3b", ssd)])
def test_weights_match_the_programs_layout(name, family):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(name).reduced()
    c = dataclasses.asdict(cfg)
    ours = family.make_weights(c, 5, torch.device("cpu"))
    theirs = init_params(cfg, 0, device="meta")

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes(v, f"{prefix}/{k}"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(shapes(v, f"{prefix}/{i}"))
            return out
        return {prefix: (tuple(tree.shape), tree.dtype)}

    assert shapes(ours) == shapes(theirs)
    total = sum(t[0] and torch.Size(t[0]).numel()
                for t in shapes(ours).values())
    assert total == cfg.param_count()
    again = family.make_weights(c, 5, torch.device("cpu"))
    assert torch.equal(again["embed"], ours["embed"])
    other = family.make_weights(c, 6, torch.device("cpu"))
    assert not torch.equal(other["embed"], ours["embed"])


def test_mamba2_initial_decay_and_step_sizes():
    from repro_torch.configs import get_config

    c = dataclasses.asdict(get_config("mamba2-1.3b").reduced())
    p = ssd.make_weights(c, 1, torch.device("cpu"))["layers"][0]["mixer"]
    a = torch.exp(p["A_log"])
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt > 0.9e-3) & (dt < 0.11)).all())
    assert p["A_log"].dtype == torch.float32
