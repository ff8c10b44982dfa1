"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own sizes: the program on many seeds, and on a few of them the
control (the configuration's lower-precision step put in the program's
place) and the faults a run can have, each against the plain reference.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... \
        --control-seeds <k> --out <file.json>

Serving cells: for each seed the sampled patients (the longest and others
drawn from the seed, as a run samples them) through the generate CLI's
engine, and on the first k seeds through the engine with its int8 paths on
(the control: quant "trunk"; "full" beside it), one slice of each answer altered where it is produced
(zeroed), and half of every chunk left out (the other half served in its
place). Training cells: for each seed the first checked steps of the
program and of the float32 reference; on the first k seeds the reference
with float8 convs in the program's place (the control) and the program on
half of each batch, its losses the mean over that half. A state left
unchanged reads 1 on the change's number by its definition and needs no
run. Every per-slice and per-leaf reading goes to the output file.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import card  # noqa: E402
from portbench.harness import serve_closed_loop as serve  # noqa: E402
from portbench.harness import train_pool as train  # noqa: E402
from portbench.harness.common import log  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402


def free():
    gc.collect()
    torch.cuda.empty_cache()


def slice_stats(got: np.ndarray, ref: np.ndarray, dev) -> dict:
    """Per-slice readings of a served series against the reference's: the
    mean |difference|, and the low-passed difference of the run's
    ``serve_numbers`` at several patch sizes."""
    d = (torch.from_numpy(got).to(dev, torch.float32)
         - torch.from_numpy(ref).to(dev, torch.float32))
    z, h, w = d.shape
    out = {"per_slice": d.abs().mean(dim=(1, 2)).tolist(),
           "signed": d.mean(dim=(1, 2)).tolist(), "max": float(d.abs().max())}
    for b in (4, 8, 16, 32):
        p = d.reshape(z, h // b, b, w // b, b).mean(dim=(2, 4))
        out[f"lowpass{b}"] = p.abs().mean(dim=(1, 2)).tolist()
    return out


def serve_seed(config, traffic, seed, dev, faulty: bool) -> dict:
    sizes = serve.sample_sizes(dict.fromkeys(traffic["sizes"]),
                               traffic["sample"], seed)
    vol = serve.make_volume(config, traffic, seed, dev)

    def served(engine):
        return {z: serve.launch(engine, config, traffic, vol, z).cpu().numpy()
                for z in sizes}

    runs = {}
    engine = serve.make_engine(config, seed, dev)
    runs["program"] = served(engine)
    if faulty:
        inner = engine._forward_parts

        def half_chunk(sl, *args):
            out = inner(sl[:len(sl) // 2], *args)
            return {k: torch.cat([v, v])[:len(sl)] for k, v in out.items()}

        engine._forward_parts = half_chunk
        runs["fault_half_chunk"] = served(engine)
        altered = {}
        for z, arr in runs["program"].items():
            arr = arr.copy()
            arr[z // 2] = 0
            altered[z] = arr
        runs["fault_altered_slice"] = altered
    del engine
    free()
    if faulty:
        for quant in ("trunk", "full"):
            engine = serve.make_engine(config, seed, dev, quant=quant)
            runs[f"control_{quant}"] = served(engine)
            del engine
            free()
    from portbench.reference.serve import serve_patient

    st_w, lung_w = serve.generator_pair(config, seed, dev)
    out = {name: {} for name in runs}
    for z in sizes:
        ref = serve_patient(vol[:z], st_w, lung_w, config, dev)
        for name, got in runs.items():
            out[name][z] = slice_stats(got[z], ref, dev)
    return out


class HalfBatch(train.Trainer):
    """The program's step with half of each batch left out, its losses the
    mean over the rest: a fault planted underneath the step's call."""

    def __call__(self, batch):
        n = len(batch["a"]) // 2
        return super().__call__({k: v[:n] for k, v in batch.items()})


def train_seed(config, traffic, seed, dev, faulty: bool) -> dict:
    n = traffic["checked_steps"]
    out = {}
    trainer = train.Trainer(config, traffic, seed, dev)
    pool = train.make_pool(config, traffic, seed, dev)
    out["program"] = train.first_steps(
        trainer, pool, n, config if dev.type == "cuda" else None)
    out["remat"] = trainer.remat
    del trainer
    free()
    if faulty:
        trainer = HalfBatch(config, traffic, seed, dev)
        out["fault_half_batch"] = train.first_steps(trainer, pool, n)
        del trainer
    del pool
    free()
    out["reference"] = train.reference_steps(config, traffic, seed, dev, n)
    free()
    if faulty:
        from portbench.reference.cyclegan import fp8_conv

        out["control"] = train.reference_steps(config, traffic, seed, dev, n,
                                               conv=fp8_conv)
        free()
    torch.backends.cudnn.benchmark = config["path"]["cudnn_benchmark"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    card.set_cache_dirs(ROOT)
    card.require_card(cell["chips"])
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = config.get("path", {}).get(
        "cudnn_benchmark", False)
    one = serve_seed if traffic["kind"] == "serve_closed_loop" else train_seed
    results = {"workload": args.workload, "card": card.gpu_line(),
               "seeds": {}}
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        results["seeds"][str(seed)] = one(config, traffic, seed, dev,
                                          i < args.control_seeds)
        log(f"{args.workload} seed {seed}: {time.perf_counter() - t:.1f} s")
        Path(args.out).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
