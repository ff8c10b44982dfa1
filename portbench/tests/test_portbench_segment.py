"""The segmentation cell on the CPU at tiny sizes: its traffic file, the
FLOP count of the stated plan, the new readers on an empty reading, the
nnU-Net reference's imports, and a run of its driver with JAX and the JAX
package unimportable."""
import copy
import importlib
import json

import pytest

from portbench.roofline.nnunet import norm_bytes, norms, patch_flop
from portbench.tests.test_portbench_imports import FORBIDDEN, _run

NEW_READERS = ("mfu_pct.segment", "in3d_roofline.segment",
               "overlap_pct.segment")


def test_the_traffic_file_parses_and_names_its_driver(spec):
    c = spec.cell("segment-thin-512")
    traffic = spec.traffic(c["traffic"])
    assert traffic["kind"] == "segment_closed_loop" and c["chips"] == 1
    assert hasattr(importlib.import_module(
        "portbench.harness.segment_closed_loop"), "run")
    assert traffic["sizes"] == spec.traffic("thin-series")["sizes"]


def test_the_stated_plan_is_about_a_teraflop_a_patch(spec):
    plan = spec.config("totalseg-nnunet-3d-fullres")["network"]
    assert abs(patch_flop(plan) - 0.9576e12) < 1e9
    assert len(norms(plan)) == 22
    assert norms(plan)[0] == (128 ** 3, 32) and norms(plan)[-1] == \
        (128 ** 3, 32)
    assert norm_bytes(plan, 2) == 2 * norm_bytes(plan, 1)


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_read_nothing_from_an_empty_reading(spec, name,
                                                        monkeypatch):
    from portbench import program
    from portbench.harness.common import Reading

    monkeypatch.setattr(program, "program_trace", lambda: None)
    config = spec.config("totalseg-nnunet-3d-fullres")
    reading = Reading(config, {}, {"seconds": 1.0, "patches": None}, None,
                      {"in3d_launches": 0, "in3d_bound_bytes": 0.0})
    assert spec.reader(name)(reading) is None


def test_the_nnunet_reference_runs_without_the_port():
    proc = _run('''
        import sys
        sys.path.insert(0, ".")
        import torch
        from portbench.reference import nnunet
        plan = {"input_channels": 1, "features": [32, 64],
                "kernel_sizes": [[3, 3, 3]] * 2,
                "strides": [[1, 1, 1], [2, 2, 2]],
                "n_conv_per_stage": [2, 2], "n_conv_per_stage_decoder": [2],
                "classes": 3, "patch_size": [8, 8, 8]}
        p = {k: torch.randn(s) * 0.1 for k, s in
             nnunet.param_shapes(plan).items()}
        out = nnunet.forward(p, torch.randn(1, 1, 8, 8, 8), plan)
        assert out.shape == (1, 3, 8, 8, 8)
        assert not any(m.split(".")[0] == "ducosy_tpu_torch"
                       for m in sys.modules)
        print("ok")
    ''', FORBIDDEN | {"ducosy_tpu_torch"})
    assert proc.returncode == 0, proc.stderr[-3000:]


def tiny_segment(spec):
    c = spec.cell("segment-thin-512")
    config = copy.deepcopy(spec.config(c["config"]))
    traffic = copy.deepcopy(spec.traffic(c["traffic"]))
    config["network"].update(
        features=[32, 64], kernel_sizes=[[3, 3, 3]] * 2,
        strides=[[1, 1, 1], [2, 2, 2]], n_conv_per_stage=[2, 2],
        n_conv_per_stage_decoder=[2], classes=4, patch_size=[16, 16, 16])
    config.update(compute_dtype="float32", patch_batch=3)
    config["path"]["norms_per_forward"] = 6
    traffic.update(sizes=[30, 40], img_size=48, profile_patients=2)
    return config, traffic


def test_the_driver_runs_without_jax(spec):
    """The driver at a tiny size on the CPU, traced, with JAX and the JAX
    package unimportable: correct, the counters' readings present, and
    sys.modules free of both afterwards."""
    proc = _run(f'''
        import json, sys, time
        sys.path.insert(0, ".")
        from portbench.harness import card, segment_closed_loop
        from portbench.harness.common import Ctx
        from portbench.harness.spec import Spec
        config, traffic = json.loads({json.dumps(json.dumps(
            tiny_segment(spec)))})
        spec = Spec()
        out = segment_closed_loop.run(Ctx(
            seed=2 ** 33 + 5, seconds=0.3, trace=True, config=config,
            traffic=traffic, t0=time.perf_counter(), device="cpu",
            check_path=False))
        assert out.correct, out.checks
        print({{m["name"]: spec.reader(m["name"])(out.reading)
               for m in spec.per_layer("segment-thin-512")}})
        print("held", card.forbidden_modules())
    ''', FORBIDDEN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "held []"
    assert "'overlap_pct.segment': None" not in lines[-2]
    assert "'mfu_pct.segment': None" not in lines[-2]
