"""The models' ``shard`` call sites against the reference's: each module's
``shard`` (``transformer``, ``ssd``, ``moe``, ``encdec`` in both
packages) is replaced at run time by a recorder -- no file of either
package changes -- and one forward of each family (the reference's
layer scan unrolled, so each layer calls it) must call it with the same
specs on tensors of the same shapes, in the same order.  The decode
step's sites (the cache and scores constraints of
``decode_seq_constraint``, then the logits') are held the same way."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models.encdec as r_encdec
import repro.models.moe as r_moe
import repro.models.ssd as r_ssd
import repro.models.transformer as r_tr
import repro_torch.models.encdec as p_encdec
import repro_torch.models.moe as p_moe
import repro_torch.models.ssd as p_ssd
import repro_torch.models.transformer as p_tr
from repro.configs import get_arch as r_arch
from repro.models import build_model as r_build
from repro_torch import convert
from repro_torch.configs import get_arch as p_arch
from repro_torch.models import build_model as p_build

from test_torch_common import CPU
from test_torch_models import _batch_np, _params_np

FAMILIES = ["qwen2-1.5b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-2.7b",
            "phi-3-vision-4.2b", "whisper-medium"]


def _recorder(monkeypatch, modules, calls):
    """Replace ``shard`` in each module by a recorder of (spec, shape)
    that returns its input."""
    def rec(x, *spec):
        calls.append((tuple(spec), tuple(x.shape)))
        return x
    for m in modules:
        monkeypatch.setattr(m, "shard", rec)


def _both(arch, **plan):
    rc, pc = r_arch(arch).reduced(), p_arch(arch).reduced()
    if plan:
        rc = dataclasses.replace(rc, plan=dataclasses.replace(rc.plan,
                                                              **plan))
        pc = dataclasses.replace(pc, plan=dataclasses.replace(pc.plan,
                                                              **plan))
    rp = _params_np(rc)
    rm = r_build(rc, unroll=True)
    pm = p_build(pc, device=CPU)
    return rc, rm, pm, rp, convert.model_params(rp, CPU)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_calls_shard_at_the_references_sites(arch, monkeypatch):
    import jax.numpy as jnp
    rc, rm, pm, rp, pp = _both(arch)
    batch = _batch_np(rc, b=2, s=16)
    ref, port = [], []
    _recorder(monkeypatch, (r_tr, r_ssd, r_moe, r_encdec), ref)
    _recorder(monkeypatch, (p_tr, p_ssd, p_moe, p_encdec), port)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    if rc.family == "encdec":
        # the reference's Model.forward scans the enc-dec layers whatever
        # its ``unroll``: call its functions unrolled
        enc = r_encdec.encode(rc, rp, rb["frames"], unroll=True)
        r_encdec.decode_train(rc, rp, rb["tokens"], enc, unroll=True)
    else:
        rm.forward(rp, rb)
    pm.forward(pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert ref, "the reference calls no shard"
    assert port == ref


def test_decode_calls_shard_at_the_references_sites(monkeypatch):
    """yi-9b's plan keeps the cache sequence-sharded in decode
    (``decode_seq_constraint``): its K/V and scores constraints, per
    layer, then the logits'."""
    import jax.numpy as jnp
    rc, rm, pm, rp, pp = _both("yi-9b", decode_seq_constraint=True)
    ref, port = [], []
    _recorder(monkeypatch, (r_tr,), ref)
    _recorder(monkeypatch, (p_tr,), port)
    rcache, pcache = rm.init_cache(2, 8), pm.init_cache(2, 8)
    tok = np.array([3, 5], np.int32)
    rm.decode_step(rp, rcache, jnp.asarray(tok))
    pm.decode_step(pp, pcache, torch.as_tensor(tok))
    assert len(ref) == 3 * rc.num_layers + 1
    assert port == ref
