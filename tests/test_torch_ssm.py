"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU.

Inputs are numpy draws from a seed; parameters come from JAX
``init_ssm`` through ``convert.lm_params_from_numpy``.  Held: the chunked
SSD and its sequential oracle on the JAX test's (L, chunk) cases, with the
final state; ``ssm_block`` on both dispatch branches; ``ssm_prefill``'s
output and every ``SSMState`` field with its dtype (the conv registers in
the activations' float32); ``ssm_decode`` from ``init_ssm_state``'s
bfloat16 registers and from a prefill's float32 ones; ``ssm_block``'s
gradients against ``jax.grad``.

Tolerances: the SSD at the JAX test's rtol/atol 1e-4
(``tests/test_moe_ssm.py``); the block's float32 outputs at rtol 1e-4 with
atol 1e-5 x max|JAX value| (``tests/test_torch_lm.py``'s rule: both sides
compute in float32 and sum matmuls in other orders); bfloat16 registers at
atol 2^-7 x max|JAX value| (one bf16 ulp where a last-bit f32 difference
flips a rounding); each gradient leaf within 1e-4 x max|JAX leaf|
(``tests/test_torch_train.py``).  dt goes through ``F.softplus`` in the
port and ``jax.nn.softplus`` in JAX: they differ by less than 2e-9
relative, and only above 20, which no draw here reaches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SSMConfig as JSSMConfig  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.config import SSMConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402

torch.set_num_threads(2)

D_MODEL, B = 32, 2
CFG = dict(d_state=16, d_conv=4, expand=2, head_dim=8, chunk_size=16)
GRAD_TOL = 1e-4


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def params():
    jp = JSSM.init_ssm(jax.random.PRNGKey(0), D_MODEL, JSSMConfig(**CFG),
                       jnp.float32)
    npp = jax.tree.map(np.asarray, jp)
    return jp, lm_params_from_numpy(npp, "cpu")


def activations(seed, L):
    return np.random.default_rng(seed).normal(
        size=(B, L, D_MODEL)).astype(np.float32)


@pytest.mark.parametrize("L,chunk", [(64, 16), (128, 32), (96, 32)])
def test_ssd_chunked_and_reference_match_jax(L, chunk):
    rng = np.random.default_rng(0)
    b, h, p, n = 2, 4, 8, 16
    x = rng.normal(size=(b, L, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(
        jnp.asarray(rng.normal(size=(b, L, h)), jnp.float32)))
    A = np.asarray(-jnp.exp(jnp.asarray(rng.normal(size=(h,)), jnp.float32)))
    Bm = rng.normal(size=(b, L, n)).astype(np.float32)
    Cm = rng.normal(size=(b, L, n)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    targs = [t(a) for a in (x, dt, A, Bm, Cm)]
    jy1, jf1 = JSSM.ssd_chunked(*jargs, chunk)
    jy2, jf2 = JSSM.ssd_reference(*jargs)
    ty1, tf1 = TSSM.ssd_chunked(*targs, chunk)
    ty2, tf2 = TSSM.ssd_reference(*targs)
    assert ty1.shape == (b, L, h, p) and tf1.shape == (b, h, p, n)
    for got, want in ((ty1, jy1), (tf1, jf1), (ty2, jy2), (tf2, jf2),
                      (ty1, jy2), (tf1, jf2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("L,use_chunked", [(48, True), (48, False),
                                           (40, True)])
def test_ssm_block_matches_jax(L, use_chunked):
    """48 = 3 chunks of 16 takes the chunked scan (when asked); 40 is no
    multiple of the chunk and runs the sequential oracle either way."""

    jp, tp = params()
    x = activations(1, L)
    want = JSSM.ssm_block(jp, jnp.asarray(x), JSSMConfig(**CFG), D_MODEL,
                          use_chunked=use_chunked)
    got = TSSM.ssm_block(tp, t(x), SSMConfig(**CFG), D_MODEL,
                         use_chunked=use_chunked)
    assert got.shape == (B, L, D_MODEL) and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("L", [48, 40, 2])
def test_ssm_prefill_output_and_state_match_jax(L):
    """Every ``SSMState`` field, dtype included; at L = 2 the registers hold
    a zero in front of the two activations."""

    jp, tp = params()
    x = activations(2, L)
    jy, jst = JSSM.ssm_prefill(jp, jnp.asarray(x), JSSMConfig(**CFG),
                               D_MODEL)
    ty, tst = TSSM.ssm_prefill(tp, t(x), SSMConfig(**CFG), D_MODEL)
    close(ty, jy)
    assert isinstance(tst, TSSM.SSMState)
    assert tst._fields == jst._fields == ("h", "conv_x", "conv_B", "conv_C")
    for got, want in zip(tst, jst):
        assert got.dtype == torch.float32
        assert np.asarray(want).dtype == np.float32
        assert got.shape == np.asarray(want).shape
        close(got, want)
    if L == 2:
        assert not tst.conv_x[:, 0].any()


@pytest.mark.parametrize("start", ["init_bf16", "prefill_f32"])
def test_ssm_decode_matches_jax(start):
    """Five decode steps from ``init_ssm_state`` (bfloat16 registers, f32
    h) or from a 32-token prefill (float32 registers).  The port writes the
    state in place and keeps its dtypes, as JAX's ``_conv_step`` keeps the
    buffer's."""

    jp, tp = params()
    jcfg, tcfg = JSSMConfig(**CFG), SSMConfig(**CFG)
    if start == "init_bf16":
        jst = JSSM.init_ssm_state(B, D_MODEL, jcfg, jnp.bfloat16)
        tst = TSSM.init_ssm_state(B, D_MODEL, tcfg, torch.bfloat16, "cpu")
    else:
        x0 = activations(3, 32)
        _, jst = JSSM.ssm_prefill(jp, jnp.asarray(x0), jcfg, D_MODEL)
        _, tst = TSSM.ssm_prefill(tp, t(x0), tcfg, D_MODEL)
    dtypes = [f.dtype for f in tst]
    xs = activations(4, 5)
    for i in range(5):
        jy, jst = JSSM.ssm_decode(jp, jnp.asarray(xs[:, i:i + 1]), jst, jcfg,
                                  D_MODEL)
        ty, out = TSSM.ssm_decode(tp, t(xs[:, i:i + 1]), tst, tcfg, D_MODEL)
        assert out is tst and [f.dtype for f in tst] == dtypes
        close(ty, jy)
        for got, want in zip(tst, jst):
            bf16 = got.dtype == torch.bfloat16
            close(got, np.asarray(want.astype(jnp.float32)),
                  atol_scale=2.0 ** -7 if bf16 else 1e-5)


def test_ssm_block_gradients_match_jax():
    """d/d(params, x) of <ssm_block(params, x), w> on the chunked branch."""

    jp, tp = params()
    x = activations(5, 48)
    w = np.random.default_rng(6).normal(size=(B, 48, D_MODEL)).astype(
        np.float32)
    jcfg, tcfg = JSSMConfig(**CFG), SSMConfig(**CFG)

    def jloss(p, xx):
        return jnp.sum(JSSM.ssm_block(p, xx, jcfg, D_MODEL) * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = t(x).requires_grad_(True)
    for leaf in tp.values():
        leaf.requires_grad_(True)
    (TSSM.ssm_block(tp, tx, tcfg, D_MODEL) * t(w)).sum().backward()
    assert set(tp) == set(jg)
    for name, leaf in tp.items():
        want = np.asarray(jg[name])
        err = float(np.abs(leaf.grad.numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (name, err)
    want = np.asarray(jgx)
    err = float(np.abs(tx.grad.numpy() - want).max())
    assert err <= GRAD_TOL * float(np.abs(want).max())


def test_init_ssm_dtypes_and_ranges():
    """A_log, D and dt_bias are float32 whatever the parameter dtype; dt
    = softplus(dt_bias) lies in [1e-3, 1e-1]; the stacked layout."""

    tcfg = SSMConfig(**CFG)
    p = TSSM.init_ssm(torch.Generator().manual_seed(0), D_MODEL, tcfg,
                      torch.bfloat16, "cpu", lead=(3, 2))
    jp = JSSM.init_ssm(jax.random.PRNGKey(0), D_MODEL, JSSMConfig(**CFG),
                       jnp.bfloat16)
    assert set(p) == set(jp)
    for name, leaf in p.items():
        assert leaf.shape == (3, 2) + jp[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == jp[name].dtype.name, name
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    close(p["A_log"][1, 1], np.asarray(jp["A_log"]))
    assert torch.equal(p["D"], torch.ones_like(p["D"]))


def test_ssd_chunked_float32_error_is_the_references():
    """Draws as above in chunks of 256, where the decays sum to about
    -200: the chunked form's decay matrix (differences of within-chunk
    cumsums) loses float32 precision.  In float64 both forms agree; in
    float32 the port's chunked form is as far from float64 as the JAX
    package's, and both are further than the sequential form."""

    rng = np.random.default_rng(3)
    b, L, h, p, n, chunk = 1, 512, 4, 16, 32, 256
    x = rng.normal(size=(b, L, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(b, L, h))))
    A = -np.exp(rng.normal(size=(h,)))
    Bm, Cm = rng.normal(size=(b, L, n)), rng.normal(size=(b, L, n))
    args = (x, dt, A, Bm, Cm)
    z1, _ = TSSM.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    z2, _ = TSSM.ssd_reference(*(torch.from_numpy(a) for a in args))
    want = z2.numpy()
    assert np.abs(z1.numpy() - want).max() <= 1e-9 * np.abs(want).max()
    ty, _ = TSSM.ssd_chunked(*(t(a) for a in args), chunk)
    ts, _ = TSSM.ssd_reference(*(t(a) for a in args))
    jy, _ = JSSM.ssd_chunked(*(jnp.asarray(a, jnp.float32) for a in args),
                             chunk)
    t_err = np.abs(ty.numpy() - want).max()
    j_err = np.abs(np.asarray(jy) - want).max()
    seq_err = np.abs(ts.numpy() - want).max()
    # the same order: 2.6e-4 against JAX's 3.8e-4, the sequential 2.0e-5
    assert 0.25 * j_err <= t_err <= 4.0 * j_err, (t_err, j_err)
    assert t_err > 4 * seq_err, (t_err, seq_err)
