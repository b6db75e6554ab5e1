"""Every contraction that carries haplotype frequencies asks for full
float32 precision in the lowered program; only the distance matmuls, whose
0/±1 operands are exact in any mode, leave it to the backend."""

import re

import jax
import jax.numpy as jnp
import pytest


def _precisions(fn, *args):
    """Operand precision of every dot_general in fn's lowered StableHLO
    (traced afresh: a new closure misses jit's trace cache)."""
    text = jax.jit(lambda *a: fn(*a)).lower(*args).as_text()
    return [re.search(r"precision = \[(\w+), \w+\]", ln).group(1)
            if "precision" in ln else "DEFAULT"
            for ln in text.splitlines() if "dot_general" in ln]


def _estep(C=4, c=8, H=16):
    from hibag_tpu.models import em
    return em._em_estep_chunk, (
        jnp.ones((C, H)), jnp.ones((C, H)), jnp.ones((c, H, H)),
        jnp.ones((c,)), jnp.ones((C, c, 3)), 10.0)


def _eval(C=4, H=16, N=8, L=128, A=5):
    from hibag_tpu.models import em
    # the undecorated function, so each lowering traces it afresh
    fn = lambda *a: em.evaluate_candidates.__wrapped__(*a, n_alleles=A)
    return fn, (jnp.ones((H, L)), jnp.zeros(H, jnp.int32), 3,
                jnp.ones((C, H)), jnp.ones((C, H)),
                jnp.zeros((C, N), jnp.int8), jnp.zeros((N, L), jnp.int8),
                jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32),
                jnp.ones(N, bool), jnp.ones(N))


def _scores(H=16, N=8, L=128, A=5):
    from hibag_tpu.ops.scoring import posterior_scores
    fn = lambda *a: posterior_scores.__wrapped__(*a, n_alleles=A)
    return fn, (jnp.ones((H, L)), jnp.ones(H), jnp.zeros(H, jnp.int32),
                jnp.zeros((N, L), jnp.int8))


#: (builder, number of distance matmuls that may stay at DEFAULT)
CASES = {"em_estep": (_estep, 0), "evaluate_candidates": (_eval, 2),
         "posterior_scores": (_scores, 2)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_contractions_are_highest(name):
    build, n_distance = CASES[name]
    fn, args = build()
    prec = _precisions(fn, *args)
    assert prec.count("DEFAULT") == n_distance, prec
    assert prec.count("HIGHEST") == len(prec) - n_distance >= 1, prec


@pytest.mark.parametrize("name", ["em_estep", "evaluate_candidates"])
def test_lower_precision_is_caught(monkeypatch, name):
    """The check above fails if the EM/eval precision drops to HIGH (on
    the GPU that may mean bf16 or TF32 passes)."""
    from hibag_tpu.models import em
    monkeypatch.setattr(em, "VALUE_PRECISION", jax.lax.Precision.HIGH)
    fn, args = CASES[name][0]()
    prec = _precisions(fn, *args)
    assert "HIGH" in prec and "HIGHEST" not in prec, prec
