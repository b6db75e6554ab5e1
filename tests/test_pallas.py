"""Fused Pallas (Triton route) ensemble kernel vs the jnp reference, run in
interpret mode on the CPU; the compiled kernel is checked on the card by
chip_smoke.py and the `gpu`-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hibag_tpu.constants import LOG_MIN_RARE_FREQ
from hibag_tpu.ops.scoring import posterior_scores, unordered_from_S
from hibag_tpu.ops.scoring_triton import BIG, ensemble_posterior_triton


def _random_classifier(rng, H=40, L=128, A=14, N=24, n_snp=20):
    bits = rng.integers(0, 2, (H, L)).astype(np.float32)
    bits[:, n_snp:] = 0
    freq = rng.random(H).astype(np.float32)
    freq[H - 5:] = 0  # padded slots
    freq[freq > 0] /= freq[freq > 0].sum()
    allele = np.sort(rng.integers(0, A, H)).astype(np.int32)
    geno = rng.integers(0, 4, (N, L)).astype(np.int8)
    geno[:, n_snp:] = 3
    return bits, freq, allele, geno


def _kernel_inputs(bits, freq, allele, g, w, A):
    """Kernel operands for classifiers bits [C,H,L], freq/allele [C,H],
    genotypes g [n,C,L] and weights w [C,n], laid out by predict's own
    _prepare_ensemble."""
    from types import SimpleNamespace
    from hibag_tpu.models.predict import _prepare_ensemble
    C = bits.shape[0]
    Cp = max(16, 1 << (C - 1).bit_length())
    wt = np.zeros((g.shape[0], Cp), np.float32)
    wt[:, :C] = w.T
    tensors = _prepare_ensemble(
        SimpleNamespace(hap_bits=bits, hap_freq=freq, hap_allele=allele), A)
    return (*tensors, jnp.asarray(g), jnp.asarray(wt))


def _one(bits, freq, allele, geno, A):
    """Kernel with one classifier of weight 1: unordered posterior sums."""
    ens, lm = ensemble_posterior_triton(
        *_kernel_inputs(bits[None], freq[None], allele[None],
                        geno[:, None], np.ones((1, len(geno)), np.float32),
                        A), interpret=True)
    return np.asarray(ens)[:, :A, :A], np.asarray(lm)[:, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_matches_reference(seed):
    rng = np.random.default_rng(seed)
    bits, freq, allele, geno = _random_classifier(rng)
    ref = posterior_scores(jnp.asarray(bits), jnp.asarray(freq),
                           jnp.asarray(allele), jnp.asarray(geno), 14)
    ens, lm = _one(bits, freq, allele, geno, 14)
    Q = np.asarray(unordered_from_S(ref["S"]))
    tot = np.asarray(ref["total"])
    np.testing.assert_allclose(ens, Q / tot[:, None, None], rtol=1e-4,
                               atol=1e-9)
    lref = np.log(tot) + LOG_MIN_RARE_FREQ * np.asarray(ref["dmin"])
    np.testing.assert_allclose(lm, lref, rtol=1e-5, atol=1e-4)


def test_pallas_missing_heavy():
    rng = np.random.default_rng(7)
    bits, freq, allele, geno = _random_classifier(rng, N=8)
    geno[:4] = 3  # all-missing samples
    ref = posterior_scores(jnp.asarray(bits), jnp.asarray(freq),
                           jnp.asarray(allele), jnp.asarray(geno), 14)
    ens, _ = _one(bits, freq, allele, geno, 14)
    Q = np.asarray(unordered_from_S(ref["S"]))
    np.testing.assert_allclose(ens, Q / np.asarray(ref["total"])[:, None,
                                                                  None],
                               rtol=1e-4, atol=1e-9)


def _random_ensemble(rng, C=4, H=24, L=128, A=9, n=16, P=300):
    hb = np.zeros((C, H, L), np.float32)
    hf = np.zeros((C, H), np.float32)
    ha = np.zeros((C, H), np.int32)
    si = np.full((C, L), -1, np.int32)
    for c in range(C):
        ns = rng.integers(8, 20)
        nh = rng.integers(6, H)
        hb[c, :nh, :ns] = rng.integers(0, 2, (nh, ns))
        f = rng.random(nh)
        hf[c, :nh] = f / f.sum()
        ha[c, :nh] = np.sort(rng.integers(0, A, nh))
        si[c, :ns] = rng.permutation(P)[:ns]
    sw = np.zeros(P, np.int32)
    for c in range(C):
        sw[si[c][si[c] >= 0]] += 1
    geno = rng.integers(0, 4, (n, P)).astype(np.uint8)
    geno[0] = 3                                  # an all-missing sample
    return hb, hf, ha, si, sw, geno


def test_ensemble_accumulate_matches_scan():
    """The fused whole-ensemble path equals the per-classifier scan."""
    from types import SimpleNamespace
    from hibag_tpu.models.predict import (_predict_block, _predict_block_ens,
                                          _prepare_ensemble)
    A = 9
    hb, hf, ha, si, sw, geno = _random_ensemble(np.random.default_rng(11))
    args = (jnp.asarray(hb), jnp.asarray(hf), jnp.asarray(ha),
            jnp.asarray(si), jnp.asarray(sw), jnp.asarray(geno))
    ens1, wsum1, lm1, w1 = _predict_block(*args, A, "prob", 1)
    tensors = _prepare_ensemble(
        SimpleNamespace(hap_bits=hb, hap_freq=hf, hap_allele=ha), A)
    ens2, wsum2, lm2, w2 = _predict_block_ens(
        tensors, jnp.asarray(si), jnp.asarray(sw), jnp.asarray(geno), A,
        interpret=True)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(wsum2), np.asarray(wsum1),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(ens2), np.asarray(ens1),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(np.asarray(lm2), np.asarray(lm1),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bh,H,A", [(64, 128, 14), (32, 80, 9),
                                    (16, 40, 16)])
def test_ensemble_accumulate_kernel_direct(bh, H, A):
    """The kernel vs an explicit numpy evaluation of distances, penalties
    and contractions, over tile widths, haplotype counts that span several
    tiles (with a partial last one) and allele counts below the padded
    allele axis."""
    rng = np.random.default_rng(bh + H + A)
    C, L, N = 3, 128, 6
    hb = (rng.random((C, H, L)) < 0.5).astype(np.float32)
    hb[:, :, 30:] = 0
    allele = np.sort(rng.integers(0, A, (C, H)), axis=1)
    freq = rng.dirichlet(np.ones(H), C).astype(np.float32)
    valid = np.ones((C, H), bool)
    valid[:, H - 8:] = False
    freq[~valid] = 0.0
    g = rng.integers(0, 4, (N, C, L)).astype(np.int8)
    g[:, :, 30:] = 3
    w = rng.random((C, N)).astype(np.float32)
    ens, lm = ensemble_posterior_triton(
        *_kernel_inputs(hb, freq, allele, g, w, A), bh=bh, interpret=True)
    ens, lm = np.asarray(ens), np.asarray(lm)
    Ap = ens.shape[1]

    ens_ref = np.zeros((N, Ap, Ap))
    for c in range(C):
        W = np.zeros((H, Ap))
        W[np.arange(H), allele[c]] = freq[c]
        for s in range(N):
            gs = g[s, c].astype(np.int64)
            obs = gs <= 2
            h = hb[c]
            D = np.where(obs[None, None],
                         np.abs(h[:, None, :] + h[None, :, :] - gs), 0.0
                         ).sum(-1)
            D = np.where(valid[c][:, None] & valid[c][None, :], D, np.inf)
            dm = D.min()
            pen = np.where(np.isfinite(D),
                           np.exp(LOG_MIN_RARE_FREQ * (D - dm)), 0.0)
            S = W.T @ pen @ W
            tot = S.sum()
            np.testing.assert_allclose(
                lm[s, c], np.log(w[c, s]) + np.log(tot)
                + LOG_MIN_RARE_FREQ * dm, rtol=1e-5, atol=1e-4)
            ens_ref[s] += S * (2.0 - np.eye(Ap)) * w[c, s] / tot
    np.testing.assert_allclose(ens, ens_ref, rtol=1e-4, atol=1e-9)
    assert np.all(lm[:, C:] == -np.inf)


def test_prepare_ensemble_layout():
    """_prepare_ensemble pads H to the kernel tile, A to a power of two,
    marks empty and padded classifier slots invalid and splits W exactly
    enough that hi + lo reproduces it to ~16 bits."""
    from types import SimpleNamespace
    from hibag_tpu.models.predict import _prepare_ensemble
    from hibag_tpu.ops.scoring_triton import TILE_H

    hb, hf, ha, *_ = _random_ensemble(np.random.default_rng(5), C=3, H=70)
    pk = SimpleNamespace(hap_bits=hb, hap_freq=hf, hap_allele=ha)
    bits, wh, wl, inval = _prepare_ensemble(pk, 9, cpad=2)
    Hp = -(-70 // TILE_H) * TILE_H
    assert bits.shape == (5, Hp, 128) and bits.dtype == jnp.bfloat16
    assert wh.shape == wl.shape == (5, Hp, 16)
    inval = np.asarray(inval)
    assert inval.shape == (5, Hp)
    np.testing.assert_array_equal(inval[:3, :70] == 0, hf > 0)
    assert np.all(inval[3:] == BIG) and np.all(inval[:, 70:] == BIG)
    W = np.asarray(wh, np.float32) + np.asarray(wl, np.float32)
    ref = np.zeros((3, 70, 16), np.float32)
    for c in range(3):
        ref[c, np.arange(70), ha[c]] = hf[c]
    np.testing.assert_allclose(W[:3, :70], ref, rtol=2e-5, atol=0)
    assert np.all(W[3:] == 0) and np.all(W[:, 70:] == 0)


def test_kernel_large_h_matches_scan():
    """A model with 600 haplotypes per classifier (ten 64-row tiles, once
    past the old kernel's ceiling) predicts through the tiled kernel and
    agrees with the scan engine."""
    from types import SimpleNamespace
    from hibag_tpu.models.predict import (_predict_block, _predict_block_ens,
                                          _prepare_ensemble)
    rng = np.random.default_rng(0)
    C, H, P, A, n = 2, 600, 24, 5, 3
    hb = np.zeros((C, H, 128), np.float32)
    hb[:, :, :P] = rng.integers(0, 2, (C, H, P))
    hf = rng.dirichlet(np.ones(H), C).astype(np.float32)
    ha = np.sort(rng.integers(0, A, (C, H)), axis=1).astype(np.int32)
    si = np.full((C, 128), -1, np.int32)
    si[:, :P] = np.arange(P)
    sw = np.full(P, C, np.int32)
    geno = rng.integers(0, 3, (n, P)).astype(np.uint8)
    args = (jnp.asarray(si), jnp.asarray(sw), jnp.asarray(geno))
    ens1, *_ = _predict_block(jnp.asarray(hb), jnp.asarray(hf),
                              jnp.asarray(ha), *args, A, "prob", 1)
    tensors = _prepare_ensemble(
        SimpleNamespace(hap_bits=hb, hap_freq=hf, hap_allele=ha), A)
    ens2, *_ = _predict_block_ens(tensors, *args, A, interpret=True)
    np.testing.assert_allclose(np.asarray(ens2), np.asarray(ens1),
                               rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("backend,engine,vote,f64,want", [
    ("gpu", "auto", "prob", False, "triton"),
    ("gpu", "triton", "prob", False, "triton"),
    ("gpu", "jnp", "prob", False, "jnp"),
    ("gpu", "auto", "majority", False, "jnp"),
    ("gpu", "auto", "prob", True, "jnp"),
    ("cpu", "auto", "prob", False, "jnp"),
    ("cpu", "jnp", "majority", False, "jnp"),
])
def test_resolve_engine(monkeypatch, backend, engine, vote, f64, want):
    """predict's engine choice per backend: never interpret mode, never a
    kernel for another platform; the fused kernel only on a GPU."""
    from hibag_tpu.models import predict as P
    monkeypatch.setattr(P.jax, "default_backend", lambda: backend)
    assert P.resolve_engine(engine, vote, f64) == want


def test_resolve_engine_rejects_kernel_off_gpu(monkeypatch):
    from hibag_tpu.models import predict as P
    monkeypatch.setattr(P.jax, "default_backend", lambda: "cpu")
    with pytest.raises(ValueError, match="needs a GPU"):
        P.resolve_engine("triton")
    with pytest.raises(ValueError, match="unknown engine"):
        P.resolve_engine("pallas")


@pytest.mark.gpu
@pytest.mark.parametrize("H", [24, 180, 600])
def test_kernel_compiled_matches_scan(gpu, H):
    """The kernel as compiled for the card agrees with the scan engine, at
    padded haplotype counts of one tile (64) and of three and ten tiles
    (192, 640: not powers of two)."""
    from types import SimpleNamespace
    from hibag_tpu.models.predict import (_predict_block, _predict_block_ens,
                                          _prepare_ensemble)
    A = 9
    hb, hf, ha, si, sw, geno = _random_ensemble(np.random.default_rng(2),
                                                H=H, n=64)
    args = (jnp.asarray(si), jnp.asarray(sw), jnp.asarray(geno))
    ens1, *_ = _predict_block(jnp.asarray(hb), jnp.asarray(hf),
                              jnp.asarray(ha), *args, A, "prob", 1)
    tensors = _prepare_ensemble(
        SimpleNamespace(hap_bits=hb, hap_freq=hf, hap_allele=ha), A)
    ens2, *_ = _predict_block_ens(tensors, *args, A)
    np.testing.assert_allclose(np.asarray(ens2), np.asarray(ens1),
                               rtol=1e-4, atol=1e-8)
