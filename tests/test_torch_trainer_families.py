"""The port's ``Trainer`` on the MoE, VLM and enc-dec families against the
reference's train step: olmoe-1b-7b, phi-3-vision-4.2b and
whisper-medium, reduced, under their full configs' microbatches and remat
(olmoe and phi-3-vision four microbatches, remat "dots"), train three
steps on the CPU.  The trainer's own batches (the VLM's embeddings, the
enc-dec family's frames) go through the reference's jitted
``make_train_step`` from the trainer's initial state, carried over with
numpy.  The losses are held step by step at 1e-5, the final parameters
at ``test_torch_train.STEP_F32``.

Both sides compute in float32: the trainer's step bundle is built with
``compute_dtype=float32`` (patched in), where the trainer's default is
bf16 compute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU
from test_torch_train import STEP_F32, _flat
from repro.configs import get_arch as r_arch
from repro.models import build_model as r_build
from repro.optim import adamw_init as r_adamw_init
from repro.train.step import make_train_step as r_make_train_step
import repro_torch.train.trainer as trainer_lib
from repro_torch.configs import get_arch as p_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

FAMILIES = ["olmoe-1b-7b", "phi-3-vision-4.2b", "whisper-medium"]
SHAPE = ShapeConfig("tiny", 32, 4, "train")
STEPS = 3
LOSS_RTOL = 1e-5


def _cfg(get, arch):
    """The reduced config under the full config's microbatches and
    remat."""
    full = get(arch)
    cfg = full.reduced()
    return dataclasses.replace(cfg, plan=dataclasses.replace(
        cfg.plan, microbatches=full.plan.microbatches,
        remat=full.plan.remat))


def _jnp_tree(tree):
    """A port tree (nested dicts of tensors) as the reference's: the same
    nesting, jnp arrays of copies (on the CPU a jnp array may share a
    numpy array's memory, and the trainer updates its state in place)."""
    return {k: _jnp_tree(v) if isinstance(v, dict)
            else jnp.asarray(v.detach().cpu().numpy().copy())
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_steps_match_the_reference_step(arch, monkeypatch):
    pc = _cfg(p_arch, arch)
    rc = _cfg(r_arch, arch)
    monkeypatch.setattr(trainer_lib, "build_step_bundle", functools.partial(
        trainer_lib.build_step_bundle,
        model_kw={"compute_dtype": torch.float32}))
    t = Trainer(pc, SHAPE, tcfg=TrainerConfig(steps=STEPS, log_every=0),
                device=CPU)
    params, opt = t.init_state()
    r_params = _jnp_tree(params)
    batches = [t._pipeline().batch_at(s) for s in range(STEPS)]
    out = t.train(params, opt)
    assert [h["step"] for h in out["history"]] == list(range(STEPS))

    rm = r_build(rc, compute_dtype=jnp.float32)
    step_fn = jax.jit(r_make_train_step(
        rm, microbatches=rc.plan.microbatches))
    r_opt = r_adamw_init(r_params)
    for s, (h, batch) in enumerate(zip(out["history"], batches)):
        r_params, r_opt, r_m = step_fn(
            r_params, r_opt, {k: jnp.asarray(v.numpy())
                              for k, v in batch.items()}, jnp.int32(s))
        np.testing.assert_allclose(h["loss"], float(r_m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {s}")
    # the VLM's embeddings and the enc-dec family's frames went through
    assert {"vlm": "embeds", "encdec": "frames"}.get(
        pc.family, "tokens") in batches[0]
    want, got = _flat(r_params), _flat(out["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_F32, err_msg=k)
