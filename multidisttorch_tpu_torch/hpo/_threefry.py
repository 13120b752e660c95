"""The PBT explore draw, bit-exact with the JAX package's, in numpy.

The JAX package draws a PBT perturbation factor for (generation, target
lane) as ``randint(fold_in(fold_in(fold_in(key(seed), TAG), gen), lane), 0,
len(factors))`` under the partitionable threefry-2x32 key derivation
(``multidisttorch_tpu/train/steps.py::pbt_perturb_factor``). That stream
is small and counter-based, so it is written out here and the port draws
the same factors:

- ``key(seed)`` is the pair ``(0, seed)``;
- ``fold_in(k, d)`` is ``threefry(k, (0, d))``;
- ``split(k)[i]`` is ``threefry(k, (0, i))``;
- a scalar's 32 random bits are the XOR of ``threefry(k, (0, 0))``'s two
  words;
- ``randint(k, (), 0, n)`` splits ``k`` in two, takes 32 bits of each
  (``hi``, ``lo``) and returns
  ``((hi % n) * ((2**16 % n)**2 % n) + lo % n) % n``.

Everything is uint32 arithmetic that wraps, as on the device.
"""

from __future__ import annotations

import numpy as np

# The domain-separation tag folded into key(seed) for the explore stream
# (the JAX package's PBT_EXPLORE_TAG).
PBT_EXPLORE_TAG = 0x9E3779B9

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: tuple[int, int], count: tuple[int, int]) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds: the two output words for one
    two-word counter under a two-word key."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (count[0] + ks[0]) & _MASK
    x1 = (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a seed below 2**32."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return 0, int(seed)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)``, ``data`` taken as uint32."""
    return threefry2x32(k, (0, int(data) & _MASK))


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(k, num)`` (partitionable)."""
    return [threefry2x32(k, (0, i)) for i in range(num)]


def random_bits32(k: tuple[int, int]) -> int:
    """A scalar's 32 random bits (``jax.random.bits(k, (), uint32)``)."""
    a, b = threefry2x32(k, (0, 0))
    return a ^ b


def randint(k: tuple[int, int], minval: int, maxval: int) -> int:
    """``jax.random.randint(k, (), minval, maxval)`` for a span that fits
    in 16 bits (a factor table's index)."""
    span = maxval - minval
    if span <= 0:
        return minval
    if span >= 1 << 16:
        raise ValueError(f"span {span} needs the wide randint path, which is not written out")
    k1, k2 = split(k)
    hi, lo = random_bits32(k1), random_bits32(k2)
    multiplier = ((1 << 16) % span) ** 2 % span
    return minval + ((hi % span) * multiplier + lo % span) % span


def pbt_explore_key(seed: int) -> tuple[int, int]:
    """The population's explore stream root: ``fold_in(key(seed), TAG)``."""
    return fold_in(key(seed), PBT_EXPLORE_TAG)


def pbt_perturb_factor(explore_key: tuple[int, int], gen: int, lane: int, perturb_factors) -> np.float32:
    """The explore draw for (generation, target lane): the factor table's
    entry at ``randint(fold_in(fold_in(explore_key, gen), lane))``."""
    k = fold_in(fold_in(explore_key, gen), lane)
    return np.float32(perturb_factors[randint(k, 0, len(perturb_factors))])


def pbt_perturb_factors(explore_key: tuple[int, int], gen: int, lanes: int, perturb_factors) -> np.ndarray:
    """Every lane's draw for generation ``gen``: ``(lanes,)`` f32."""
    return np.array([pbt_perturb_factor(explore_key, gen, k, perturb_factors) for k in range(lanes)], np.float32)
