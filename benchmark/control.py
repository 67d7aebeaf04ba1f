"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--parts]

For each seed, in one process: the cell is set up and its window runs for
``--seconds`` at the cell's own load; its outputs are held against the
reference, which gives the program's readings (the lower ones). Then the
control, the reference computed one precision below what the
configuration states (``CONTROL`` of the configuration's reference
module, and bfloat16 for VLAD and the scan), stands in the program's
place on the same sample, which gives the control's readings (the upper
ones). With ``--parts`` each lowered part is also read alone. With
``--look`` a gallery cell also compares the program's descriptors of one
pool batch with the reference's, and counts the rows whose nearest centre
differs and how near a tie those rows are. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

if str(pathlib.Path(__file__).resolve().parents[1]) not in sys.path:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.reference import vlad as ref_vlad  # noqa: E402
from benchmark.run import Cell, find, log, manifest  # noqa: E402


def control_precision(ref) -> dict:
    return {**ref.CONTROL, "vlad": "bfloat16"}


def look(cell: Cell) -> dict:
    """The program's descriptors of the first pool batch against the
    reference's: the largest difference over the largest value, the share
    of entries off by more than a bfloat16 step of their value, and the
    rows whose nearest centre (float64) differs, with the reference's
    relative margin between its two nearest centres on those rows; and
    how far apart the reference's encodings of two different images lie
    (``1 - cos``), which an output given to the wrong image reads."""
    import torch

    imgs = cell.pool[0]
    got, _ = cell.encoder.feature_extractor.extract_batch(imgs)
    got = torch.as_tensor(got).to(cell.device, torch.float64)
    want, mask = cell.ref.descriptors(cell.cfg, cell.weights, imgs, cell.device)
    want = want.to(torch.float64)
    c = cell.centers.to(torch.float64)

    def dist(x):
        return (x * x).sum(-1, keepdim=True) - 2.0 * x @ c.T + (c * c).sum(-1)

    dw = dist(want)
    two = dw.topk(2, dim=-1, largest=False).values
    flips = (dist(got).argmin(-1) != dw.argmin(-1)) & (mask > 0)
    margin = ((two[..., 1] - two[..., 0]) / two[..., 0].clamp_min(1e-300))[flips]
    diff = (got - want).abs()
    enc, _ = ref_vlad.encode(want, mask, c, power=cell.cfg["vlad"]["power_norm_weight"],
                             epsilon=cell.cfg["vlad"]["epsilon"])
    enc = enc / enc.norm(dim=1, keepdim=True)
    pair_gap = (1.0 - enc @ enc.T)[~torch.eye(len(enc), dtype=torch.bool, device=enc.device)]
    return {"distinct_images_gap_min": float(pair_gap.min()),
            "distinct_images_gap_median": float(pair_gap.median()),
            "desc_max_rel": float(diff.max() / want.abs().max()),
            "desc_off_share": float((diff > want.abs() * 2.0 ** -8 + 1e-30).double().mean()),
            "rows": int((mask > 0).sum()), "flipped_rows": int(flips.sum()),
            "flip_margin_max": float(margin.max()) if flips.any() else None,
            "flip_margin_median": float(margin.median()) if flips.any() else None}


def readings(cell: Cell, seconds: float, parts: bool, want_look: bool = False) -> dict:
    cell.warm_up()
    seen_look = look(cell) if want_look and cell.mix["kind"] == "closed" else None
    loop = cell.window(seconds)
    cell.free()
    t = time.perf_counter()
    program, seen = cell.check_numbers(loop)
    check_s = time.perf_counter() - t
    low = control_precision(cell.ref)
    out = {"program": program, "control": cell.check_numbers(loop, precision=low)[0],
           "seen": seen, "check_s": check_s, "attempted": loop["attempted"],
           "failed": loop["failed"]}
    if seen_look is not None:
        out["look"] = seen_look
    if parts:
        out["parts"] = {k: cell.check_numbers(loop, precision={k: v})[0] for k, v in low.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--parts", action="store_true")
    p.add_argument("--look", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: no result")
        return 3
    workload = find(manifest()["workloads"], args.workload, "workload")
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = Cell(workload, seed, "cuda")
        rec = {"workload": args.workload, "seed": seed,
               **readings(cell, args.seconds, args.parts, args.look),
               "device": torch.cuda.get_device_name(0)}
        print(json.dumps(rec), flush=True)
        del cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
