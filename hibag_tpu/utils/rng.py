"""R-compatible random number generation (Mersenne-Twister `unif_rand`).

The reference consumes R's RNG stream for bootstrap resampling
(RandomNum(n) = int(n * unif_rand()), reference src/LibHLA.cpp:118-126,
2220-2245) and for mtry candidate sampling via partial Fisher–Yates
(src/LibHLA.cpp:949-962). Replicating R's default Mersenne-Twister and its
`set.seed` scrambling makes training runs reproducible against R-generated
traces — device-side randomness is never needed (the reference uses none).

Implements R's documented behavior: set.seed scrambles the seed through 50+N
iterations of the 69069 LCG to fill the 624-word MT state; unif_rand applies
MT19937 tempering and a (0,1) fixup.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_I2_32M1 = 2.3283064365386963e-10  # 1 / (2^32 - 1)


class RRng:
    """R's default RNG: Mersenne-Twister with R's seeding and fixup."""

    def __init__(self, seed: int | None = None, state: np.ndarray | None = None):
        if state is not None:
            self.mt = np.asarray(state, dtype=np.uint32).copy()
            assert self.mt.shape == (_N,)
            self.mti = _N
        elif seed is not None:
            self.set_seed(seed)
        else:
            self.set_seed(np.random.SeedSequence().entropy % (2**31))

    def set_seed(self, seed: int) -> None:
        """R's set.seed: scramble via LCG, fill 625 words, keep last 624."""
        s = np.uint32(seed & 0xFFFFFFFF)
        for _ in range(50):
            s = np.uint32((np.uint64(69069) * np.uint64(s) + 1) & 0xFFFFFFFF)
        # n_seed = 625 for MT (index word + 624 state words); the index word
        # is overwritten by the fixup, so only the 624 state words matter
        words = np.empty(_N + 1, dtype=np.uint32)
        for j in range(_N + 1):
            s = np.uint32((np.uint64(69069) * np.uint64(s) + 1) & 0xFFFFFFFF)
            words[j] = s
        self.mt = words[1:].copy()
        self.mti = _N  # force twist on first draw

    def _twist(self) -> None:
        # In-place MT19937 semantics: words at index >= N-M read ALREADY
        # UPDATED words (n[i] = n[i+M-N] ^ ...), and the final word's pair
        # partner is the updated n[0]. A naive vectorization over the old
        # state diverges from R at draw 227 of every twist block
        # (regression: tests/test_train.py::test_rng_long_stream).
        o = self.mt.astype(np.uint64)
        n = np.empty(_N, dtype=np.uint64)

        def tb(a, b):
            y = (a & _UPPER) | (b & _LOWER)
            return (y >> 1) ^ np.where(y & 1, _MATRIX_A, 0).astype(np.uint64)

        k = _N - _M                                   # 227
        n[:k] = o[_M:] ^ tb(o[:k], o[1:k + 1])        # uses old words only
        n[k:2 * k] = n[:k] ^ tb(o[k:2 * k], o[k + 1:2 * k + 1])
        n[2 * k:_N - 1] = n[k:_M - 1] ^ tb(o[2 * k:_N - 1], o[2 * k + 1:_N])
        n[_N - 1] = n[_M - 1] ^ tb(o[_N - 1:_N], n[0:1])[0]
        self.mt = (n & 0xFFFFFFFF).astype(np.uint32)
        self.mti = 0

    def genrand_uint32(self, n: int = 1) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self.mti >= _N:
                self._twist()
            take = min(n - filled, _N - self.mti)
            y = self.mt[self.mti:self.mti + take].astype(np.uint64)
            # MT19937 tempering
            y ^= y >> 11
            y ^= (y << 7) & 0x9D2C5680
            y ^= (y << 15) & 0xEFC60000
            y ^= y >> 18
            out[filled:filled + take] = (y & 0xFFFFFFFF).astype(np.uint32)
            self.mti += take
            filled += take
        return out

    def unif_rand(self, n: int | None = None):
        """R's unif_rand: u32 / (2^32 - 1), forced into the open (0,1)."""
        m = 1 if n is None else n
        v = self.genrand_uint32(m).astype(np.float64) * _I2_32M1
        v = np.where(v <= 0.0, 0.5 * _I2_32M1, v)
        v = np.where(1.0 - v <= 0.0, 1.0 - 0.5 * _I2_32M1, v)
        return float(v[0]) if n is None else v

    def random_num(self, n: int) -> int:
        """Reference RandomNum: int in [0, n) (src/LibHLA.cpp:118-126)."""
        v = int(n * self.unif_rand())
        return n - 1 if v >= n else v

    def bootstrap_counts(self, n: int) -> np.ndarray:
        """Multinomial bootstrap with >=1 out-of-bag sample, consuming the
        stream exactly like NewClassifierBootstrap (src/LibHLA.cpp:2220-2245)."""
        while True:
            counts = np.zeros(n, dtype=np.int32)
            for _ in range(n):
                counts[self.random_num(n)] += 1
            if (counts == 0).any():
                return counts

