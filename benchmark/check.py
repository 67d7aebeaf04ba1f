"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference on the same inputs.

Gallery cells: a sample, drawn from the seed, of the encodings that
``encode`` returned in the window. The reference extracts the sampled
images' descriptors and encodes them in float64; the numbers compared are
the widest ``1 - cos`` between an encoding and the reference's
(``enc_gap``) and the widest ``|encoding - reference|`` (``enc_diff``).

Query cells: a sample, drawn from the seed, of the queries answered in the
window. The reference's encoding of the query image (made at set-up, when
the gallery's near copies of it were drawn) is scored against every
gallery row (drawn again from the seed) in float64 and sorted. The numbers
compared are the widest gap between the program's j-th score and the
reference's j-th best score (``score_gap``) and the widest gap by which
the reference scores a returned row below its own j-th best
(``rank_gap``): a returned row that is not among the best, or a score
that is off, shows in one of them, while two rows that swap places on a
near tie do not.

Each number is held against its limit in ``benchmark/limits/<cell>.json``.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from benchmark import images
from benchmark.reference import vlad as ref_vlad

DIR = pathlib.Path(__file__).resolve().parent / "limits"


def limits(cell: str) -> dict:
    """``{number: limit}`` of a cell; empty where none is set yet."""
    path = DIR / f"{cell}.json"
    if not path.is_file():
        return {}
    with open(path) as f:
        return {k: v["limit"] for k, v in json.load(f)["numbers"].items()}


def reference_encodings(cfg: dict, ref, weights: dict, imgs: np.ndarray, centers, device,
                        precision=None) -> tuple[torch.Tensor, int, float]:
    """The reference's float64 encodings of ``imgs``, the number of clusters
    its descriptors reach and the mean number of weighted descriptors an
    image holds. ``precision`` lowers parts for the control (the key
    ``vlad`` the VLAD's, the rest the extractor's)."""
    precision = dict(precision or {})
    vlad_precision = precision.pop("vlad", "float64")
    desc, mask = ref.descriptors(cfg, weights, imgs, device, precision or None)
    v = cfg["vlad"]
    enc, labels = ref_vlad.encode(desc, mask, centers, precision=vlad_precision,
                                  power=v["power_norm_weight"], epsilon=v["epsilon"])
    return enc, ref_vlad.nonempty_clusters(labels), float(mask.sum(1).mean())


def encoding_numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``enc_gap``: the widest ``1 - cos`` of a row; ``enc_diff``: the widest
    absolute difference of an entry."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    cos = (got * want).sum(1) / (got.norm(dim=1) * want.norm(dim=1)).clamp_min(1e-300)
    return {"enc_gap": float((1.0 - cos).max()), "enc_diff": float((got - want).abs().max())}


def search_numbers(ids: np.ndarray, got_scores: np.ndarray, ref_scores: torch.Tensor) -> dict:
    """``score_gap`` and ``rank_gap`` of answers ``ids``/``got_scores``
    ``(Q, k)`` against the reference's ``(Q, n)`` scores."""
    k = ids.shape[1]
    best = torch.sort(ref_scores, dim=1, descending=True).values[:, :k].cpu().numpy()
    of_ids = ref_scores.gather(1, torch.as_tensor(ids, device=ref_scores.device)).cpu().numpy()
    return {"score_gap": float(np.abs(got_scores - best).max()),
            "rank_gap": float(np.max(best - of_ids))}


def judge(numbers: dict, cell_limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {value, limit}})`` over the numbers the cell's
    limits name: correct when there is at least one and each lies within
    its limit. A number the limits do not name is read, not compared."""
    out = {name: {"value": numbers.get(name, float("nan")), "limit": limit}
           for name, limit in cell_limits.items()}
    ok = bool(out) and all(np.isfinite(r["value"]) and r["value"] <= r["limit"]
                           for r in out.values())
    return ok, out


def gallery_rows(cfg: dict, mix: dict, seed: int, device, near: torch.Tensor) -> torch.Tensor:
    """The gallery the index serves, drawn from the seed on ``device``:
    ``cfg["index"]["rows"]`` Gaussian rows, of which rows at places drawn
    from the seed are replaced by near copies of each query image's
    reference encoding (``near``, one row an image), one copy at each
    cosine of the mix's ``near_copies``: a query has a clear best few, as
    "images like this one" have, and an answer given to the wrong image
    scores far below them."""
    gen = images.generator(seed, "gallery_rows", device)
    n, d = cfg["index"]["rows"], cfg["encoding_dim"]
    rows = torch.randn((n, d), generator=gen, device=device)
    e = near.to(device=device, dtype=torch.float64)
    e = e / e.norm(dim=1, keepdim=True)
    cosines = mix["near_copies"]
    place = torch.randperm(n, generator=gen, device=device)[:len(e) * len(cosines)]
    for j, c in enumerate(cosines):
        noise = torch.randn((len(e), d), generator=gen, device=device, dtype=torch.float64)
        noise -= (noise * e).sum(1, keepdim=True) * e
        noise /= noise.norm(dim=1, keepdim=True)
        rows[place[j * len(e):(j + 1) * len(e)]] = (c * e + (1.0 - c * c) ** 0.5 * noise).float()
    return rows

