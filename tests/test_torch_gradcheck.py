"""``torch.autograd`` of the bidder's objective stack, in float64, against
a central difference and against ``jax.grad`` of the reference.

Case for case ``tests/test_gradcheck.py``: every Tier-3 objective term
and the full ensemble settlement objective (smooth and hard), over all
``PRODUCT_ORDER`` products and both ``pue_aware`` settings, at points in
the interior of each term's smooth pieces, plus the smooth surrogate at
and around the MIN_RESIDUAL_LOAD boundary.  Each gradient must

* differ from the float64 central difference by a relative 1e-3 at most
  (the reference's own tolerance), and
* equal ``jax.grad`` of the reference, evaluated under
  ``jax.enable_x64(True)``, to a relative 1e-8 wherever |grad| > 1e-6.

The reference file reaches float64 through ``jax.experimental``'s
``enable_x64``, which this JAX no longer has; these cases use
``jax.enable_x64`` and so run here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import n
import repro.core.tier3 as r_tier3
import repro.grid.markets as r_markets
from repro.optim import bidding as r_bid
import repro_torch.core.tier3 as tier3
from repro_torch.optim import bidding

REL_TOL = 1e-3
JAX_REL = 1e-8
PRODUCTS = list(range(len(r_markets.PRODUCT_ORDER)))
AWARE = [True, False]
F64 = torch.float64


def _f64(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F64)


def _ad(f, x0: float) -> float:
    x = _f64(x0).requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    return float(g)


def _jax_grad(f, x0: float) -> float:
    with jax.enable_x64(True):
        return float(jax.grad(f)(jnp.float64(x0)))


def check(f, f_ref, point: dict, h: float = 1e-6, what=()) -> None:
    """``f``/``f_ref`` take a dict name -> float64 value.  The port's
    gradient in every variable against the central difference (<
    REL_TOL) and against the reference's ``jax.grad`` (to JAX_REL), the
    latter taken for all the variables in one call."""
    xs = {k: _f64(v).requires_grad_(True) for k, v in point.items()}
    grads = torch.autograd.grad(f(xs), list(xs.values()))
    with jax.enable_x64(True):
        want = jax.grad(f_ref)({k: jnp.float64(v) for k, v in point.items()})
    for (k, x0), g in zip(point.items(), grads):
        def fk(v):
            p = {kk: _f64(vv) for kk, vv in point.items()}
            p[k] = v
            return f(p)

        ad, w = float(g), float(want[k])
        with torch.no_grad():
            fd = float((fk(_f64(x0) + h) - fk(_f64(x0) - h)) / (2.0 * h))
        assert np.isfinite(ad) and np.isfinite(fd), (what, k)
        assert abs(ad - fd) / max(abs(ad), abs(fd), 1e-6) < REL_TOL, (
            what, k, ad, fd)
        if max(abs(ad), abs(w)) > 1e-6:
            assert abs(ad - w) / max(abs(ad), abs(w)) < JAX_REL, (
                what, k, ad, w)


@pytest.mark.parametrize("pue_aware", AWARE)
@pytest.mark.parametrize("product_idx", PRODUCTS)
def test_q_ffr_grad(product_idx, pue_aware):
    del product_idx  # q_ffr is product-free; keep the full matrix anyway

    def f(a, mod=tier3):
        return mod.q_ffr(a["mu"], a["rho"], a["t_amb"], pue_aware=pue_aware)

    check(f, lambda a: f(a, r_tier3), {"mu": 0.7, "rho": 0.2, "t_amb": 15.0},
          what=pue_aware)


@pytest.mark.parametrize("pue_aware", AWARE)
@pytest.mark.parametrize("product_idx", PRODUCTS)
def test_revenue_score_grad(product_idx, pue_aware):
    def f(a, mod=tier3, cast=_f64):
        return mod.revenue_score(a["mu"], a["rho"], cast(15.0), product_idx,
                                 pue_aware=pue_aware)

    check(f, lambda a: f(a, r_tier3, jnp.float64), {"mu": 0.8, "rho": 0.15},
          what=(product_idx, pue_aware))


@pytest.mark.parametrize("pue_aware", AWARE)
@pytest.mark.parametrize("product_idx", PRODUCTS)
def test_throughput_score_grad(product_idx, pue_aware):
    del pue_aware  # throughput is meter-free; keep the full matrix anyway

    def f(a, mod=tier3, cast=_f64):
        return mod.throughput_score(a["mu"], a["rho"], cast(0.88),
                                    product_idx, ckpt_cost_s=cast(30.0))

    check(f, lambda a: f(a, r_tier3, jnp.float64), {"mu": 0.75, "rho": 0.2},
          what=product_idx)


def _ensemble64(n_ens: int = 8) -> dict:
    return dict(green=np.linspace(0.2, 0.9, n_ens),
                t_amb=np.linspace(5.0, 20.0, n_ens),
                price_rel=np.exp(np.linspace(-0.2, 0.2, n_ens)),
                epd=np.full((n_ens,), 4.0))


W64 = np.asarray([tier3.W_FFR, tier3.W_CFE, tier3.W_REV_DEFAULT, 0.1],
                 np.float64)


def _ens_obj(mu, rho, bid, product_idx, *, pue_aware, smooth):
    ens = bidding.BidEnsemble(**{k: torch.from_numpy(v)
                                 for k, v in _ensemble64().items()})
    return bidding.ensemble_objective(
        mu, rho, bid, ens, W64, product_idx, _f64(0.88), _f64(30.0),
        pue_aware=pue_aware, use_workload=True, smooth=smooth)


def _ens_obj_ref(mu, rho, bid, product_idx, *, pue_aware, smooth):
    ens = r_bid.BidEnsemble(**{k: jnp.asarray(v)
                               for k, v in _ensemble64().items()})
    return r_bid.ensemble_objective(
        mu, rho, bid, ens, W64, product_idx, jnp.float64(0.88),
        jnp.float64(30.0), pue_aware=pue_aware, use_workload=True,
        smooth=smooth)


@pytest.mark.parametrize("pue_aware", AWARE)
@pytest.mark.parametrize("product_idx", PRODUCTS)
@pytest.mark.parametrize("smooth", [True, False])
def test_ensemble_settlement_objective_grad(product_idx, pue_aware, smooth):
    """The full ensemble settlement objective: what the optimiser
    differentiates (smooth) and ranks with (hard)."""
    kw = dict(pue_aware=pue_aware, smooth=smooth)

    def f(p, obj=_ens_obj):
        return obj(p["mu"], p["rho"], p["bid"], product_idx, **kw)

    point = {"mu": 0.75, "rho": 0.2, "bid": 0.18}
    assert f({k: _f64(v) for k, v in point.items()}).dtype == F64
    check(f, lambda p: f(p, _ens_obj_ref), point,
          what=(product_idx, pue_aware, smooth))


@pytest.mark.parametrize("side", [-0.02, 0.0, 0.02])
def test_no_nan_or_zero_grad_at_residual_load_boundary(side):
    """The smooth surrogate keeps a finite, NONZERO gradient at and
    around ``mu - rho == MIN_RESIDUAL_LOAD``, where the hard objective's
    ``where`` gate leaves a zero-gradient plateau."""
    rho_b = 0.30
    mu_b = tier3.MIN_RESIDUAL_LOAD + rho_b + side
    kw = dict(pue_aware=True, smooth=True)

    def f_mu(mu, obj=_ens_obj, cast=_f64):
        return obj(mu, cast(rho_b), cast(rho_b), 0, **kw)

    def f_rho(rho, obj=_ens_obj, cast=_f64):
        return obj(cast(mu_b), rho, rho, 0, **kw)

    g_mu = _ad(f_mu, mu_b)
    g_rho = _ad(f_rho, rho_b)
    assert np.isfinite(g_mu) and np.isfinite(g_rho)
    assert abs(g_mu) > 1e-6 and abs(g_rho) > 1e-6
    want_mu = _jax_grad(lambda v: f_mu(v, _ens_obj_ref, jnp.float64), mu_b)
    want_rho = _jax_grad(lambda v: f_rho(v, _ens_obj_ref, jnp.float64),
                         rho_b)
    assert abs(g_mu - want_mu) / abs(want_mu) < JAX_REL
    assert abs(g_rho - want_rho) / abs(want_rho) < JAX_REL


@pytest.mark.parametrize("pue_aware", AWARE)
def test_surrogate_grad_finite_at_grid_cells(pue_aware):
    """The optimiser's first gradient is taken at the grid cells' codes:
    rho = 0 cells and mu at the mesh ends encode onto the box edge
    +-Z_CLIP.  Through ``decode`` the surrogate's gradient there is finite
    and equals ``jax.grad``'s, whose clip splits a tie's gradient in
    half."""
    MU, RHO = tier3.grid_candidates(device="cpu")
    mu = MU.reshape(-1).to(F64)
    rho = RHO.reshape(-1).to(F64)
    z0 = bidding.encode(mu, rho, rho)
    assert (z0.abs() == bidding.Z_CLIP).any()
    kw = dict(pue_aware=pue_aware, smooth=True)

    z = z0.clone().requires_grad_(True)
    m, r, b = bidding.decode(z)
    J = _ens_obj(m[:, None], r[:, None], b[:, None], 0, **kw)
    (g,) = torch.autograd.grad(J.sum(), z)
    assert torch.isfinite(g).all()

    def soft_j(zv):   # (24, 3): hours are independent, so one gradient
        mm, rr, bb = r_bid.decode(zv.T)
        ens = r_bid.BidEnsemble(**{k: jnp.asarray(v) for k, v in
                                   _ensemble64().items()})
        J = r_bid.soft_objective(
            mm[:, None], rr[:, None], bb[:, None], ens.green, ens.t_amb,
            ens.price_rel, ens.epd, W64, 0, jnp.float64(0.88),
            jnp.float64(30.0), pue_aware=pue_aware, use_revenue=True,
            use_workload=True)
        return J.mean(-1).sum()

    with jax.enable_x64(True):
        want = np.asarray(jax.grad(soft_j)(jnp.asarray(n(z0))))
    np.testing.assert_allclose(n(g), want, rtol=JAX_REL, atol=1e-12)


def test_float32_paths_unchanged():
    """Float32 in -> float32 out: the float64 harness leaves the ordinary
    float32 graphs as they are."""
    v = tier3.revenue_score(torch.tensor(0.8), torch.tensor(0.15),
                            torch.tensor(15.0), 0, pue_aware=True)
    q = tier3.q_ffr(0.7, 0.2, 15.0, pue_aware=True)
    t = tier3.throughput_score(0.75, 0.2, 0.88, 0)
    J = bidding.ensemble_objective(
        torch.tensor(0.75), torch.tensor(0.2), torch.tensor(0.18),
        bidding.BidEnsemble(*(torch.from_numpy(x.astype(np.float32))
                              for x in _ensemble64().values())),
        W64, 0, 0.88, 30.0, pue_aware=True, smooth=True)
    assert v.dtype == q.dtype == t.dtype == J.dtype == torch.float32
