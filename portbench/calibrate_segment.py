"""The readings that the segmentation cell's limits of ``correct`` are set
from, on the card at the cell's own sizes: the program on many seeds, and on
the first few of them the control (the reference with every conv's operands
rounded to float8 e4m3, the nearest step below the bf16 the configuration
states), each against the plain float32 reference.

    python3 portbench/calibrate_segment.py --workload segment-thin-512 \
        --seeds <n> ... --control-seeds <k> --out <file.json>

For each seed the sampled patients (the longest and others drawn from the
seed, as a run samples them) through the masking CLI's segmenter, their
accumulated logits and series labels against the reference's, with the
numbers a run's ``correct`` reads; every reading goes to the output file.
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

import torch  # noqa: E402

from portbench.harness import card, inputs  # noqa: E402
from portbench.harness import segment_closed_loop as seg  # noqa: E402
from portbench.harness.common import log  # noqa: E402
from portbench.harness.serve_closed_loop import sample_sizes  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402
from portbench.reference import nnunet as ref  # noqa: E402


def one_seed(config, traffic, seed, dev, control: bool) -> dict:
    plan, spacing = config["network"], traffic["spacing_mm"]
    sizes = sample_sizes(dict.fromkeys(traffic["sizes"]), traffic["sample"],
                         seed)
    vol = seg.make_volume(traffic, seed, dev)
    segmenter = seg.make_segmenter(config, seed, dev)
    got = {}
    for z in sizes:
        out = segmenter.segment_async(vol[:z], spacing, logits=True)
        got[z] = (out.logits, out.labels.cpu().numpy())
    del segmenter
    params = seg.nnunet_weights(config, inputs.derive(seed, seg.TAG_NET), dev)
    res = {"sizes": sizes, "program": {}, "control": {}}
    for z in sizes:
        res["program"][z] = seg.seg_numbers(*got[z], vol[:z], spacing, params,
                                            plan, dev)
        if control:
            logits, labels = ref.segment(torch.from_numpy(vol[:z]).to(dev),
                                         spacing, params, plan, fp8=True)
            res["control"][z] = seg.seg_numbers(
                logits, labels.to(torch.uint8).cpu().numpy(), vol[:z],
                spacing, params, plan, dev)
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return res


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
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = config["path"]["cudnn_benchmark"]
    results = {"workload": args.workload, "card": card.gpu_line(),
               "seeds": {}}
    for i, s in enumerate(args.seeds):
        t = time.perf_counter()
        results["seeds"][str(s)] = one_seed(config, traffic, s, dev,
                                            i < args.control_seeds)
        log(f"{args.workload} seed {s}: {time.perf_counter() - t:.1f} s "
            f"{results['seeds'][str(s)]}")
        Path(args.out).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
