"""The port's MoE FFN against the JAX package's, on the CPU.

Parameters come from JAX ``init_moe`` (through
``convert.lm_params_from_numpy``) and activations are numpy draws; both
sides get the same arrays.  The cases are those of
``tests/test_moe_ssm.py::test_moe_sorted_dispatch_matches_dense``, (E, k,
pad_to) in {(8, 2, 0), (8, 2, 4), (5, 2, 4), (40, 8, 16)}, plus one with
shared experts.

Routing is compared first: top-k is discontinuous, so a last-bit
difference in the router logits may swap the k-th and (k+1)-th expert of a
token.  The expert sets must be equal wherever JAX's gap between the k-th
and (k+1)-th probability exceeds ``MARGIN``; values are then held on the
tokens whose routing agreed, and the share of the others is bounded by
``FLIP_SHARE``.

Tolerances, and why:
* outputs at rtol 1e-4 with atol 1e-5 x max|JAX value|: both sides compute
  in float32 and sum the grouped products and the combine in other orders
  (``ragged_dot`` and a scatter-add there, ``matmul`` per expert and a sum
  over the k slots here);
* the aux loss at rtol 1e-5 (``tests/test_moe_ssm.py``'s own);
* gradients of sum(y * g) + aux, each leaf within ``GRAD_TOL`` x max|JAX
  leaf| (as ``tests/test_torch_train.py`` holds the dense model's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.config import MoEConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

torch.set_num_threads(2)

MARGIN = 1e-5
FLIP_SHARE = 0.02
GRAD_TOL = 1e-4
D = 48
# (E, k, pad_to, shared experts)
CASES = [(8, 2, 0, 0), (8, 2, 4, 0), (5, 2, 4, 0), (40, 8, 16, 0),
         (8, 2, 0, 2)]


def setup(E, k, pad_to, shared, seed=1, tokens=(2, 16)):
    jcfg = JMoEConfig(num_experts=E, num_experts_per_tok=k, expert_d_ff=32,
                      num_shared_experts=shared)
    tcfg = MoEConfig(num_experts=E, num_experts_per_tok=k, expert_d_ff=32,
                     num_shared_experts=shared)
    jp = jax.tree.map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(0), D, jcfg, jnp.float32, pad_to))
    x = np.random.default_rng(seed).normal(
        size=tokens + (D,)).astype(np.float32)
    return jcfg, tcfg, jp, lm_params_from_numpy(jp, "cpu"), x


def jax_gaps(jp, x, k):
    """JAX's gap between the k-th and (k+1)-th router probability of each
    token (inf where k = E)."""

    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, x.shape[-1])) @ jp["router"], axis=-1))
    top = -np.sort(-probs, axis=-1)
    if k == probs.shape[-1]:
        return np.full(probs.shape[0], np.inf)
    return top[:, k - 1] - top[:, k]


def agreed(t_idx, j_idx, gaps):
    """Tokens whose expert sets are equal; fails where they differ on a
    token whose JAX gap exceeds MARGIN."""

    t_idx = np.sort(np.asarray(t_idx), axis=-1)
    j_idx = np.sort(np.asarray(j_idx), axis=-1)
    same = (t_idx == j_idx).all(axis=-1)
    bad = ~same & (gaps > MARGIN)
    assert not bad.any(), f"routing differs on tokens {np.flatnonzero(bad)}"
    assert (~same).mean() <= FLIP_SHARE, (~same).sum()
    return same


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


@pytest.mark.parametrize("E,k,pad_to,shared", CASES)
def test_moe_ffn_matches_jax_and_both_references(E, k, pad_to, shared):
    jcfg, tcfg, jp, tp, x = setup(E, k, pad_to, shared)
    xt = x.reshape(-1, D)
    j_idx, j_w, j_aux = JMOE.route(jp, jnp.asarray(xt), jcfg)
    t_idx, t_w, t_aux = TMOE.route(tp, torch.from_numpy(xt), tcfg)
    assert t_idx.shape == (xt.shape[0], k) and t_idx.dtype == torch.int64
    assert int(t_idx.max()) < E           # padded experts never chosen
    same = agreed(t_idx, j_idx, jax_gaps(jp, x, k))
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)
    if same.all():
        # the renormalised weights in JAX's order, ties to the lower index
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        close(t_w, j_w)

    jy, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = TMOE.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    rows = same.reshape(x.shape[:2])
    close(ty[torch.from_numpy(rows)], np.asarray(jy)[rows])

    # the dense all-experts oracles of both sides
    jr, jraux = JMOE.moe_ffn_reference(jp, jnp.asarray(x), jcfg)
    tr, traux = TMOE.moe_ffn_reference(tp, torch.from_numpy(x), tcfg)
    close(tr[torch.from_numpy(rows)], np.asarray(jr)[rows])
    np.testing.assert_allclose(float(traux), float(jraux), rtol=1e-5)
    close(ty, tr)


@pytest.mark.parametrize("E,k,pad_to,shared", CASES)
def test_moe_gradients_match_jax(E, k, pad_to, shared):
    jcfg, tcfg, jp, tp, x = setup(E, k, pad_to, shared, seed=2)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    gaps = jax_gaps(jp, x, k)
    # the gradient of a token's output jumps where its routing flips, so
    # the inputs must route every token clear of a near-tie
    assert gaps.min() > MARGIN, gaps.min()

    def jloss(p, xx):
        y, aux = JMOE.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * g) + aux

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    leaves = {name: t.clone().requires_grad_(True) if name != "shared"
              else {n: v.clone().requires_grad_(True) for n, v in t.items()}
              for name, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMOE.moe_ffn(leaves, tx, tcfg)
    tl = (y * torch.from_numpy(g)).sum() + aux
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)

    def held(got, want, what):
        want = np.asarray(want)
        err = float(np.abs(got.grad.numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (what, err)

    for name, want in jgp.items():
        if name == "shared":
            for n, w in want.items():
                held(leaves[name][n], w, (name, n))
        else:
            held(leaves[name], want, name)
    held(tx, jgx, "x")
    if pad_to and E % pad_to:
        # padded experts are never routed to: no gradient reaches them
        assert float(leaves["wi_gate"].grad[E:].abs().max()) == 0.0


def test_padded_experts_never_selected():
    jcfg, tcfg, jp, tp, _ = setup(5, 2, 4, 0)
    assert tp["wi_gate"].shape[0] == 8 and tp["router"].shape[1] == 5
    x = np.random.default_rng(4).normal(size=(64, D)).astype(np.float32)
    t_idx, _, _ = TMOE.route(tp, torch.from_numpy(x), tcfg)
    assert int(t_idx.max()) < 5
    # the grouped product's run lengths never see a padded expert
    sizes = torch.bincount(t_idx.reshape(-1), minlength=8)
    assert int(sizes[5:].sum()) == 0


def test_router_top_k_breaks_ties_as_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_load_balance_loss_matches_jax_on_a_collapsed_router():
    jcfg = JMoEConfig(num_experts=8, num_experts_per_tok=2, expert_d_ff=16,
                      router_aux_loss_coef=0.01)
    tcfg = MoEConfig(num_experts=8, num_experts_per_tok=2, expert_d_ff=16,
                     router_aux_loss_coef=0.01)
    jp = jax.tree.map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(0), 32, jcfg, jnp.float32))
    xt = np.random.default_rng(5).normal(size=(512, 32)).astype(np.float32)
    collapsed = np.zeros_like(jp["router"])
    collapsed[:, 0] = 10.0
    for router in (jp["router"], collapsed):
        p = dict(jp, router=router)
        _, _, ja = JMOE.route(p, jnp.asarray(xt), jcfg)
        _, _, ta = TMOE.route(lm_params_from_numpy(p, "cpu"),
                              torch.from_numpy(xt), tcfg)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_expert_parallel_forms_raise_with_the_reason():
    """What stays of the expert-parallel forms refuses: the JAX package's
    data-parallel axes, and ranks whose experts are not split by expert
    (unpadded experts that do not divide the axis: the rules split them
    on their width)."""

    from repro_torch.models.layers import TP

    _, tcfg, _, tp, x = setup(8, 2, 0, 0)
    tx = torch.from_numpy(x)
    for kw in (dict(dp="data"), dict(dp=("pod", "data"), impl="a2a")):
        with pytest.raises(NotImplementedError, match="6.8"):
            TMOE.moe_ffn(tp, tx, tcfg, **kw)
    _, tcfg6, _, tp6, _ = setup(6, 2, 0, 0)
    width = TP.dry(4, frozenset({"mlp.wo"}))
    for impl in ("psum", "a2a"):
        with pytest.raises(NotImplementedError, match="ep_pad_to"):
            TMOE.moe_ffn(tp6, tx, tcfg6, tp=width, impl=impl)
    with pytest.raises(ValueError, match="impl"):
        TMOE.moe_ffn(tp, tx, tcfg, impl="ring")
