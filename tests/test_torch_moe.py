"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe``: routing (top-k picks and capacity positions),
``moe_ffn``'s output and aux loss, its gradient against ``jax.grad``,
``moe_ffn_decode``, ``_capacity``, ties, and a call of two dispatch
groups whose favoured expert overflows its capacity.

Routing is a discrete pick, so each parity test first asserts that both
packages route alike; where bf16 rounding makes them pick apart, the
reference's picks are fed to the port (``topi=``) and the rest of the
layer is held on them.  The parameters are the reference's layer-0 MoE
leaves of the reduced configs, filled from a numpy seed
(``test_torch_models._params_np``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as r_moe
import repro_torch.models.moe as p_moe
from repro.configs import get_arch as r_arch
from repro_torch.configs import get_arch as p_arch
from test_torch_models import _params_np

MOE_ARCHS = ["olmoe-1b-7b", "mixtral-8x22b"]
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
BF16_REL = 2e-2   # norm-relative, as the SSM families' bf16 logits
KEYS = ("router", "moe_wi", "moe_wg", "moe_wo")


def ref_routing(rc, router, x):
    """The reference's routing of ``x`` (B, S, D) through ``router``, its
    steps written out in JAX as ``repro.models.moe.moe_ffn`` takes them:
    (topi (G, S, k), pos (G, S, k), in_cap (G, S, k), dispatch (G, S, E,
    C) float32)."""
    b, s, d = x.shape
    e, k = rc.n_experts, rc.top_k
    sg = min(r_moe.GROUP_SIZE, b * s)
    g = b * s // sg
    xg = jnp.asarray(x).reshape(g, sg, d)
    logits = jnp.einsum("gsd,de->gse", xg, jnp.asarray(router),
                        preferred_element_type=jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = r_moe._capacity(sg, e, k)
    mask = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    flat = mask.transpose(0, 2, 1, 3).reshape(g, k * sg, e)
    pos = (jnp.cumsum(flat, axis=1) - 1).reshape(g, k, sg, e) \
        .transpose(0, 2, 1, 3)
    in_cap = (pos < cap) & (mask > 0)
    disp = jax.nn.one_hot(jnp.where(in_cap, pos, 0), cap,
                          dtype=jnp.float32) * in_cap[..., None]
    return (np.asarray(topi), np.asarray((pos * mask).sum(-1)),
            np.asarray(in_cap.any(-1)), np.asarray(disp.sum(2)))


def port_routing(cfg, router, x):
    b, s, d = x.shape
    sg = min(p_moe.GROUP_SIZE, b * s)
    xg = torch.as_tensor(np.asarray(x, np.float32)).reshape(-1, sg, d)
    _, _, topi = p_moe.route(torch.as_tensor(np.asarray(router)), xg,
                             cfg.top_k)
    pos, in_cap = p_moe.capacity_positions(
        topi, cfg.n_experts, p_moe._capacity(sg, cfg.n_experts, cfg.top_k))
    return topi.numpy(), pos.numpy(), in_cap.numpy()


def assert_same_routing(rc, pc, router, x):
    r_topi, r_pos, r_in, _ = ref_routing(rc, router, x)
    p_topi, p_pos, p_in = port_routing(pc, router, x)
    np.testing.assert_array_equal(p_topi, r_topi)
    np.testing.assert_array_equal(p_in, r_in)
    np.testing.assert_array_equal(np.where(p_in, p_pos, -1),
                                  np.where(r_in, r_pos, -1))


class PinnedRouting:
    """Wraps both packages' ``moe_ffn`` (patched on their modules) for one
    forward: the reference's calls record their routing, the port's calls
    take the reference's picks of the same layer (``topi=``), and count
    the slots their own routing would have picked apart."""

    def __init__(self, monkeypatch, rc):
        self.rc = rc
        self.start()
        r_orig, p_orig = r_moe.moe_ffn, p_moe.moe_ffn

        def r_wrap(cfg, lp, x):
            self.ref.append(ref_routing(
                self.rc, lp["router"], np.asarray(x, np.float32))[0])
            return r_orig(cfg, lp, x)

        def p_wrap(cfg, lp, x, topi=None):
            want = self.ref[self.i]
            self.i += 1
            _, _, own = p_moe.route(lp["router"], x.reshape(
                want.shape[0], want.shape[1], -1), cfg.top_k)
            self.flips += int((own.numpy() != want).sum())
            return p_orig(cfg, lp, x,
                          topi=torch.as_tensor(np.array(want)).long())

        monkeypatch.setattr(r_moe, "moe_ffn", r_wrap)
        monkeypatch.setattr(p_moe, "moe_ffn", p_wrap)

    def start(self):
        """Forget the recorded routing: the next reference forward
        records afresh."""
        self.ref, self.flips, self.i = [], 0, 0


def _layer(arch, seed=0):
    rc, pc = r_arch(arch).reduced(), p_arch(arch).reduced()
    lp = {k: v[0] for k, v in _params_np(rc, seed)["layers"].items()
          if k in KEYS}
    return rc, pc, lp


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch):
    rc, pc, lp = _layer(arch)
    x = _x(2, 16, rc.d_model)
    assert_same_routing(rc, pc, lp["router"], x)
    want, want_aux = r_moe.moe_ffn(rc, jax.tree.map(jnp.asarray, lp),
                                   jnp.asarray(x))
    got, got_aux = p_moe.moe_ffn(pc, {k: torch.as_tensor(v)
                                      for k, v in lp.items()},
                                 torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert got_aux.dtype == torch.float32
    np.testing.assert_allclose(float(got_aux), float(want_aux), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_ffn_on_the_references_routing(arch):
    """bf16 inputs: the reference's picks fed to the port where its own
    would differ; output held norm-relative, the aux loss at bf16's 2e-2."""
    rc, pc, lp = _layer(arch)
    x = _x(2, 16, rc.d_model, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    lpb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in lp.items()}
    topi = ref_routing(rc, lpb["router"], np.asarray(xb, np.float32))[0]
    want, want_aux = r_moe.moe_ffn(rc, lpb, xb)
    got, got_aux = p_moe.moe_ffn(
        pc, {k: torch.as_tensor(np.asarray(v, np.float32)).bfloat16()
             for k, v in lpb.items()},
        torch.as_tensor(np.asarray(xb, np.float32)).bfloat16(),
        topi=torch.as_tensor(np.array(topi)).long())
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < BF16_REL
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=2e-2)


def test_two_groups_overflow_and_drop_alike():
    """4096 tokens in two dispatch groups of 2048, 8 experts, top-2: the
    router sends every token's first slot to expert 0, which takes 640 of
    them (its capacity); both packages drop the same slots, build the same
    dispatch mask and give the same output."""
    base = r_arch("olmoe-1b-7b").reduced()
    rc = dataclasses.replace(base, n_experts=8, top_k=2)
    pc = dataclasses.replace(p_arch("olmoe-1b-7b").reduced(), n_experts=8,
                             top_k=2)
    rng = np.random.default_rng(3)
    d, f, e = rc.d_model, rc.d_ff, rc.n_experts
    lp = {"router": (0.3 / np.sqrt(d) * rng.standard_normal((d, e))),
          "moe_wi": 0.3 / np.sqrt(d) * rng.standard_normal((e, d, f)),
          "moe_wg": 0.3 / np.sqrt(d) * rng.standard_normal((e, d, f)),
          "moe_wo": 0.3 / np.sqrt(f) * rng.standard_normal((e, f, d))}
    lp["router"][:, 0] += 0.5          # expert 0 leads every token
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    x = (rng.standard_normal((2, 2048, d)) + 1.0).astype(np.float32)
    cap = r_moe._capacity(2048, e, 2)
    assert cap == p_moe._capacity(2048, e, 2) == 640
    r_topi, r_pos, r_in, r_disp = ref_routing(rc, lp["router"], x)
    assert r_topi.shape == (2, 2048, 2) and (r_topi[..., 0] == 0).all()
    assert (~r_in).sum() >= 2 * (2048 - cap)    # the slots that drop
    assert_same_routing(rc, pc, lp["router"], x)
    xg = torch.as_tensor(x).reshape(2, 2048, d)
    _, topv, topi = p_moe.route(torch.as_tensor(lp["router"]), xg, 2)
    disp, _ = p_moe.dispatch_combine(topi, topv, e, cap, torch.float32)
    np.testing.assert_array_equal(disp.numpy(), r_disp)
    want, want_aux = r_moe.moe_ffn(rc, jax.tree.map(jnp.asarray, lp),
                                   jnp.asarray(x))
    got, got_aux = p_moe.moe_ffn(pc, {k: torch.as_tensor(v)
                                      for k, v in lp.items()},
                                 torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **F32)
    assert int(p_moe.dropped_slots(pc, {"router": torch.as_tensor(
        lp["router"])}, torch.as_tensor(x)).sum()) == int((~r_in).sum())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradient_matches_jax_grad(arch):
    """The gradient of sum(out w) + aux through the layer, in every
    parameter and the input."""
    rc, pc, lp = _layer(arch)
    x = _x(2, 16, rc.d_model, seed=4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def r_loss(lp, x):
        out, aux = r_moe.moe_ffn(rc, lp, x)
        return jnp.sum(out * w) + aux

    want = jax.grad(r_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, lp),
                                            jnp.asarray(x))
    leaves = {k: torch.as_tensor(v).requires_grad_(True)
              for k, v in lp.items()}
    xt = torch.as_tensor(x).requires_grad_(True)
    out, aux = p_moe.moe_ffn(pc, leaves, xt)
    (out * torch.as_tensor(w)).sum().add(aux).backward()
    for k in KEYS:
        np.testing.assert_allclose(leaves[k].grad.numpy(),
                                   np.asarray(want[0][k]), **GRAD,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]), **GRAD)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_decode_matches_reference(arch):
    rc, pc, lp = _layer(arch)
    x = _x(1, 3, rc.d_model, seed=6)[0]
    np.testing.assert_array_equal(
        port_routing(pc, lp["router"], x[None])[0],
        ref_routing(rc, lp["router"], x[None])[0])
    want = r_moe.moe_ffn_decode(rc, jax.tree.map(jnp.asarray, lp),
                                jnp.asarray(x))
    got = p_moe.moe_ffn_decode(pc, {k: torch.as_tensor(v)
                                    for k, v in lp.items()},
                               torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same gate: both packages pick
    experts 0 .. k-1 in order, the aux loss's argmax is expert 0, and
    outputs and aux agree."""
    rc, pc, lp = _layer("olmoe-1b-7b")
    lp = dict(lp, router=np.zeros_like(lp["router"]))
    x = _x(2, 8, rc.d_model, seed=7)
    assert_same_routing(rc, pc, lp["router"], x)
    topi = port_routing(pc, lp["router"], x)[0]
    assert (topi == np.arange(rc.top_k)).all()
    want, want_aux = r_moe.moe_ffn(rc, jax.tree.map(jnp.asarray, lp),
                                   jnp.asarray(x))
    got, got_aux = p_moe.moe_ffn(pc, {k: torch.as_tensor(v)
                                      for k, v in lp.items()},
                                 torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # every gate 1/E, every first pick expert 0: aux = E (1/E) 1 = 1
    assert float(got_aux) == pytest.approx(1.0) == float(want_aux)


@pytest.mark.parametrize("tokens,experts,k", [(32, 4, 2), (16, 4, 2),
                                              (4, 4, 2), (2048, 64, 8),
                                              (2048, 8, 2), (8192, 8, 2),
                                              (7, 3, 1)])
def test_capacity_matches_reference(tokens, experts, k):
    assert p_moe._capacity(tokens, experts, k) == \
        r_moe._capacity(tokens, experts, k)
    assert (p_moe.CAPACITY_FACTOR, p_moe.GROUP_SIZE) == \
        (r_moe.CAPACITY_FACTOR, r_moe.GROUP_SIZE)
