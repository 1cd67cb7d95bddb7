"""The port's threefry (repro_torch.serving.prng) against jax.random: the
key of a seed, ``fold_in(key, pos)`` and the scalar float32 ``uniform``
must be bit-identical, in both ``jax_threefry_partitionable`` modes."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.serving import prng

torch.set_num_threads(2)

SEEDS = [0, 1000, -7, 2 ** 31 - 1]
POSITIONS = np.array([0, 1, 2, 1023, 4095, 2 ** 31 - 1], np.int64)

# uniform(fold_in(PRNGKey(1000), p)) as float32 bits, p = 0, 1, 2, 1023,
# read from jax 0.9.0 in each mode; key and fold_in bits do not depend on
# the mode.
FOLDED_1000 = [(76005737, 2103553955), (3121172949, 1033489290),
               (4251433702, 733430968), (1944357265, 1631498364)]
UNIFORM_BITS_1000 = {True: [0x3F59A490, 0x3D45AEE0, 0x3F068758, 0x3E3A6FE0],
                     False: [0x3F7631C6, 0x3CF86080, 0x3F34ACF4, 0x3F4674E4]}


def _jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    folded, bits = [], []
    for p in POSITIONS:
        k = jax.random.fold_in(key, int(p))
        folded.append(np.asarray(k, np.uint32).astype(np.int64))
        bits.append(np.asarray(jax.random.uniform(k)).view(np.uint32))
    return np.stack(folded), np.array(bits, np.int64)


def _torch_draws(seed, partitionable):
    keys = torch.tensor([prng.prng_key(seed)] * len(POSITIONS))
    folded = prng.fold_in(keys, torch.from_numpy(POSITIONS))
    u = prng.uniform(folded, partitionable)
    return folded.numpy(), u.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("partitionable", [True, False])
def test_threefry_matches_jax_in_both_modes(partitionable):
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS:
            np.testing.assert_array_equal(
                np.array(prng.prng_key(seed), np.int64),
                np.asarray(jax.random.PRNGKey(seed), np.uint32))
            want_keys, want_bits = _jax_draws(seed)
            got_keys, got_bits = _torch_draws(seed, partitionable)
            np.testing.assert_array_equal(got_keys, want_keys)
            np.testing.assert_array_equal(got_bits.astype(np.int64),
                                          want_bits)


def test_threefry_in_the_installed_mode():
    """What the engine parity tests rely on: the installed jax's mode."""
    mode = bool(jax.config.jax_threefry_partitionable)
    want_keys, want_bits = _jax_draws(1000)
    got_keys, got_bits = _torch_draws(1000, mode)
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_array_equal(got_bits.astype(np.int64), want_bits)


@pytest.mark.parametrize("partitionable", [True, False])
def test_threefry_fixed_table(partitionable):
    keys = torch.tensor([prng.prng_key(1000)] * 4)
    folded = prng.fold_in(keys, torch.tensor([0, 1, 2, 1023]))
    assert [tuple(r) for r in folded.tolist()] == FOLDED_1000
    bits = prng.uniform(folded, partitionable).view(torch.int32)
    got = [int(b) & 0xFFFFFFFF for b in bits]
    assert got == UNIFORM_BITS_1000[partitionable]


def test_prng_key_rejects_seeds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2 ** 31)
