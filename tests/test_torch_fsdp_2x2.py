"""The sharded training state on a (data 2, model 2) mesh -- a world of
four gloo ranks -- against the replicated port step and against the
reference's jitted ``build_step_bundle(cfg, shape, mesh)`` step on a
2 x 2 mesh of XLA CPU devices (a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), for every case
of ``tests/test_torch_fsdp.py`` (whose module docstring sets out the
cases, the inputs and the tolerances): local shard shapes and bytes,
three steps' loss, metrics and ``grad_norm``, and every leaf after
them."""
import numpy as np
import pytest

from test_torch_fsdp import (CASES, LOSS_F32, STEP_F32, _leaves_close,
                             _tag, check_replicated, check_shard_shapes,
                             launch, write_inputs)

SHAPE = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_2x2")
    inputs = write_inputs(d)
    ranks, ref = launch(d, (SHAPE,), ref=True)
    return inputs, ranks[_tag(SHAPE)], ref


@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_are_the_references_shard_shapes(runs, case):
    check_shard_shapes(runs[1], case, SHAPE)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_replicated_step(runs, case):
    check_replicated(runs[1], case, SHAPE)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_references_sharded_step(runs, case):
    _, recs, ref = runs
    pre = f"{case}/{_tag(SHAPE)}/"
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec[pre + "metrics"],
                                   ref[f"{case}/metrics"], **LOSS_F32,
                                   err_msg=f"rank {r}")
    _leaves_close(recs[0], ref, pre, f"{case}/", STEP_F32,
                  f"{case} against the reference on 2x2")
