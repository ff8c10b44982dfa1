"""Evaluation orchestration: DICOM->HU conversion cache, per-patient metric
workers, summary statistics, and paper figures (ducosy_tpu/eval/report.py,
the same cache files, CSV headers and pair order).

Rebuild of calculate.py's pipeline (:107-230 convert, :383-525 worker,
:684-755 summary, :527-682 figures):
  convert()               — per (dataset, patient, {vue,std,generated})
                            z-sorted HU volumes cached as .npy
  process_single_patient  — basic metrics (mae/psnr/ssim, raw + min-max
                            normalized) over the three pair types
                            (VUE<->STD baseline gap, VUE<->Gen enhancement,
                            STD<->Gen accuracy) and advanced metrics
                            (ms-ssim/lpips/emd/ts/cs/ed) for STD<->Gen only;
                            per-slice CSV per patient
  calculate()             — process pool over patients with a pickle cache
  summary_statistics()    — aggregated CSV (mean/std/median/min/max)
  save_figures()          — box/strip plots + enhancement-correlation scatter

MS-SSIM and LPIPS run on the torch device ``calculate`` is given (default
cuda); each worker of the spawn pool opens its own context on it.
"""
from __future__ import annotations

import csv
import functools
import glob
import os
import pickle
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ducosy_tpu_torch.eval import metrics as M

BASIC = ["mae", "psnr", "ssim"]
BASIC_ALL = BASIC + [f"{m}_norm" for m in BASIC]
ADVANCED = ["ms_ssim", "lpips", "emd", "ts", "cs", "ed"]
ALL_METRICS = BASIC_ALL + ADVANCED
PAIRS = ["STD_vs_Generated", "VUE_vs_STD", "VUE_vs_Generated"]


def _normalize(data: np.ndarray) -> np.ndarray:
    lo, hi = data.min(), data.max()
    if hi - lo == 0:
        return np.zeros_like(data)
    return (data - lo) / (hi - lo)


def _hu_volume(dcm_dir: str) -> Optional[np.ndarray]:
    """z-sorted HU volume from a DICOM folder (calculate.py:110-114,
    213-228: sorted by ImagePositionPatient z)."""
    from ducosy_tpu_torch.dicom import dcmread

    files = sorted(glob.glob(os.path.join(dcm_dir, "*.dcm")))
    if not files:
        return None
    slices = []
    for path in files:
        ds = dcmread(path)
        hu = (ds.pixel_array.astype(np.float32)
              * float(ds.get("RescaleSlope", 1.0))
              + float(ds.get("RescaleIntercept", 0.0)))
        ipp = ds.get("ImagePositionPatient", [0.0, 0.0, 0.0])
        z = float(ipp[2]) if isinstance(ipp, list) and len(ipp) >= 3 else 0.0
        slices.append((hu, z))
    slices.sort(key=lambda t: t[1])
    return np.stack([s[0] for s in slices])


def convert(input_dir_root: str, output_dir_root: str,
            dataset_names: List[str], *, ncct_folder: str = "POST VUE",
            cect_folder: str = "POST STD", reset: bool = False,
            masked: bool = False, skip_convert: bool = False
            ) -> Tuple[str, str, List[Tuple[str, str]]]:
    """Cache HU volumes as `{dataset}_{patient}_{category}.npy`.

    masked=True evaluates the TotalSegmentator-masked triplets under
    `<output>/masked/` into `calculated_mask/` (calculate.py:126-152).
    skip_convert=True only enumerates the task list, converting nothing —
    the reference's --skip_convert (calculate.py:183-184)."""
    if reset and skip_convert:
        # reset deletes every cached .npy and skip_convert would then
        # regenerate nothing: hours of conversion destroyed for an empty
        # report. Refuse the contradictory pair.
        raise ValueError("--reset and --skip_convert are contradictory: "
                         "reset deletes the caches skip_convert relies on")
    calc_output_dir = os.path.join(
        output_dir_root, "calculated_mask" if masked else "calculated")
    data_dir = os.path.join(calc_output_dir, "data")
    if reset and os.path.exists(calc_output_dir):
        shutil.rmtree(calc_output_dir)
    os.makedirs(data_dir, exist_ok=True)

    tasks: List[Tuple[str, str]] = []
    if masked:
        masked_root = os.path.join(output_dir_root, "masked")
        categories = [("vue", masked_root), ("std", masked_root),
                      ("generated", masked_root)]
    else:
        categories = [("vue", input_dir_root), ("std", input_dir_root),
                      ("generated", output_dir_root)]
    for category, root in categories:
        for dataset_name in dataset_names:
            base = os.path.join(root, dataset_name)
            if not os.path.isdir(base):
                continue
            for pdir in sorted(d for d in glob.glob(os.path.join(base, "*"))
                               if os.path.isdir(d)):
                patient_id = os.path.basename(pdir)
                if (dataset_name, patient_id) not in tasks:
                    tasks.append((dataset_name, patient_id))
                if skip_convert:
                    continue
                out_path = os.path.join(
                    data_dir, f"{dataset_name}_{patient_id}_{category}.npy")
                if os.path.exists(out_path):
                    continue
                sub = {"vue": ncct_folder, "std": cect_folder}.get(category)
                dcm_dir = os.path.join(pdir, sub) if sub else (
                    os.path.join(pdir, "generated")
                    if os.path.isdir(os.path.join(pdir, "generated"))
                    else pdir)
                vol = _hu_volume(dcm_dir) if os.path.isdir(dcm_dir) else None
                if vol is not None:
                    np.save(out_path, vol)
    return calc_output_dir, data_dir, tasks


def process_single_patient(task):
    """(dataset, patient, data_dir, detail_dir, device) -> {metric:
    [per-pair vals]} (calculate.py:383-525)."""
    dataset_name, patient_id, data_dir, detail_dir, device = task
    paths = {c: os.path.join(data_dir,
                             f"{dataset_name}_{patient_id}_{c}.npy")
             for c in ("vue", "std", "generated")}
    if not (os.path.exists(paths["std"]) and os.path.exists(paths["generated"])):
        return None
    std = np.load(paths["std"])
    gen = np.load(paths["generated"])
    has_vue = os.path.exists(paths["vue"])
    vue = np.load(paths["vue"]) if has_vue else None
    n = min(len(std), len(gen), len(vue) if has_vue else len(std))
    std, gen = std[:n], gen[:n]
    if has_vue:
        vue = vue[:n]

    std_n, gen_n = _normalize(std), _normalize(gen)
    basic_pairs = [(std, gen, std_n, gen_n, "STD_vs_Generated")]
    if has_vue:
        vue_n = _normalize(vue)
        basic_pairs += [(vue, std, vue_n, std_n, "VUE_vs_STD"),
                        (vue, gen, vue_n, gen_n, "VUE_vs_Generated")]

    results: Dict[str, List[float]] = {k: [] for k in ALL_METRICS}
    per_slice: Dict[str, List[List[float]]] = {k: [] for k in ALL_METRICS}

    fns = {"mae": M.calculate_mae, "psnr": M.calculate_psnr,
           "ssim": M.calculate_ssim}
    for targ, pred, targ_n, pred_n, _name in basic_pairs:
        for m in BASIC:
            v, vl = fns[m](targ, pred)
            results[m].append(v)
            per_slice[m].append(vl)
            vn, vnl = fns[m](targ_n, pred_n)
            results[f"{m}_norm"].append(vn)
            per_slice[f"{m}_norm"].append(vnl)

    targ, pred, targ_n, pred_n, _ = basic_pairs[0]
    adv_fns = {"ms_ssim": (functools.partial(M.calculate_ms_ssim,
                                             device=device), targ_n, pred_n),
               "lpips": (functools.partial(M.calculate_lpips, device=device),
                         targ_n, pred_n),
               "emd": (M.calculate_emd, targ, pred),
               "ts": (M.calculate_ts, targ, pred),
               "cs": (M.calculate_cs, targ, pred),
               "ed": (M.calculate_ed, targ, pred)}
    for m, (fn, a, b) in adv_fns.items():
        v, vl = fn(a, b)
        results[m].append(v)
        per_slice[m].append(vl)

    # per-slice detail CSV
    os.makedirs(detail_dir, exist_ok=True)
    pair_names = [p[4] for p in basic_pairs]
    header = ["Slice_Idx"]
    for m in BASIC_ALL:
        header += [f"{m}_{p}" for p in pair_names]
    header += [f"{m}_STD_vs_Generated" for m in ADVANCED]
    with open(os.path.join(detail_dir,
                           f"{dataset_name}_{patient_id}_metrics.csv"),
              "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(n):
            row = [i]
            for m in BASIC_ALL:
                for pi in range(len(pair_names)):
                    vals = per_slice[m][pi]
                    row.append(vals[i] if i < len(vals) else "")
            for m in ADVANCED:
                vals = per_slice[m][0] if per_slice[m] else []
                row.append(vals[i] if i < len(vals) else "")
            w.writerow(row)
    return results


def calculate(data_dir: str, calc_output_dir: str,
              tasks: List[Tuple[str, str]], *, num_workers: int = 4,
              use_cache: bool = True, device: str = "cuda"
              ) -> Dict[str, Dict[str, List[float]]]:
    """Pool over patients with a pickle result cache (calculate.py:758-844);
    MS-SSIM and LPIPS on ``device``."""
    detail_dir = os.path.join(calc_output_dir, "detail")
    cache_path = os.path.join(calc_output_dir, "results.pkl")
    if use_cache and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    work = [(d, p, data_dir, detail_dir, str(device)) for d, p in tasks]
    all_results: Dict[str, Dict[str, List[float]]] = {}
    if num_workers > 1:
        # spawn, not fork: a forked child cannot use a CUDA context its
        # parent opened, and forking a process with threads is unsafe;
        # spawn also mirrors the reference's per-worker metric init
        # (calculate.py:43-60,793)
        import multiprocessing

        with ProcessPoolExecutor(
                num_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            outs = list(pool.map(process_single_patient, work))
    else:
        outs = [process_single_patient(t) for t in work]
    for (dataset_name, patient_id), res in zip(tasks, outs):
        if res is not None:
            all_results[f"{dataset_name}/{patient_id}"] = res
    with open(cache_path, "wb") as f:
        pickle.dump(all_results, f)
    return all_results


def summary_statistics(results: Dict[str, Dict[str, List[float]]],
                       calc_output_dir: str) -> str:
    """Aggregate across patients -> summary CSV (calculate.py:684-755)."""
    path = os.path.join(calc_output_dir, "summary_statistics.csv")
    rows = []
    for m in ALL_METRICS:
        for pair_idx, pair in enumerate(PAIRS):
            vals = [r[m][pair_idx] for r in results.values()
                    if m in r and len(r[m]) > pair_idx
                    and np.isfinite(r[m][pair_idx])]
            if not vals:
                continue
            arr = np.asarray(vals, np.float64)
            rows.append([m, pair, len(arr), arr.mean(), arr.std(),
                         np.median(arr), arr.min(), arr.max()])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Metric", "Pair", "N", "Mean", "Std", "Median", "Min",
                    "Max"])
        w.writerows(rows)
    return path


def save_figures(results: Dict[str, Dict[str, List[float]]],
                 calc_output_dir: str):
    """Box/strip plots per metric + the VUE->STD vs VUE->Gen enhancement
    correlation scatter with Pearson r (calculate.py:527-682)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import pearsonr

    fig_dir = os.path.join(calc_output_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)

    for m in ALL_METRICS:
        data, labels = [], []
        for pair_idx, pair in enumerate(PAIRS):
            vals = [r[m][pair_idx] for r in results.values()
                    if len(r.get(m, [])) > pair_idx
                    and np.isfinite(r[m][pair_idx])]
            if vals:
                data.append(vals)
                labels.append(pair)
        if not data:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.boxplot(data, tick_labels=labels)
        for i, vals in enumerate(data):
            x = np.random.default_rng(0).normal(i + 1, 0.04, len(vals))
            ax.plot(x, vals, "o", alpha=0.4, markersize=3)
        ax.set_title(m.upper())
        fig.tight_layout()
        fig.savefig(os.path.join(fig_dir, f"{m}_distribution.png"), dpi=120)
        plt.close(fig)

    # enhancement correlation: MAE(VUE,STD) vs MAE(VUE,Gen)
    xs, ys = [], []
    for r in results.values():
        if len(r.get("mae", [])) >= 3:
            xs.append(r["mae"][1])  # VUE_vs_STD
            ys.append(r["mae"][2])  # VUE_vs_Generated
    if len(xs) >= 2:
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(xs, ys, alpha=0.6)
        rho, _p = pearsonr(xs, ys)
        lim = [0, max(max(xs), max(ys)) * 1.05]
        ax.plot(lim, lim, "k--", alpha=0.5)
        ax.set_xlabel("MAE(VUE, STD) — true enhancement")
        ax.set_ylabel("MAE(VUE, Generated) — synthesized enhancement")
        ax.set_title(f"Enhancement correlation (Pearson r={rho:.3f})")
        fig.tight_layout()
        fig.savefig(os.path.join(fig_dir, "enhancement_correlation.png"),
                    dpi=120)
        plt.close(fig)
    return fig_dir
