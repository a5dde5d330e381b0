"""The comparison that decides ``correct``.

Serving: the program's outputs of a sample of the window's requests
against the plain reference's, computed on the same frames, cameras and
weights once the window has closed.

* ``heatmap_gap``: the largest difference of a heatmap cell.
* ``heatmap_rms``: the root mean square of the cells' differences.
* ``det_gap``: over every detection the program returned, the largest
  departure from the reference's answer at the detection's cell (the cell
  by its box's centre where the program's own heatmap holds its score;
  none there is an infinite gap): the score against the reference's
  heatmap there, the centre in cells and the footprint relative to the
  reference's.
* ``missed_gap``: an exact check of the decode against the program's own
  heatmap: how far above the threshold the highest peak lies that the
  decode dropped with no detection near enough to have suppressed it (0
  when every peak is explained; the reference's maps judge the heatmap
  and the detections, this judges what is left out).
* ``recall_gap``: over every detection the reference's own maps decode to
  (the plain decode, ``reference/decode.py``) with no detection of the
  program's near it (``NMS_DIST_M`` plus a cell's diagonal between the
  centres), how far the program's heatmap at its cell lies below the
  reference's score, in logits (the heatmap is the sigmoid of the head's
  logit, whose scale does not saturate near 0 and 1); 0 when the program
  has a detection near each one, infinite where its heatmap reads 0 there.
  ``det_gap`` judges the people the program reported, this the people of
  the reference's that it left out: a heatmap that comes out all low
  reports nobody and reads high here.

A heatmap or a box that is not a number makes ``heatmap_gap``, ``det_gap`` and
``recall_gap`` infinite.

Training: the program's first steps against the reference's same steps.

* ``loss_gap``: the largest relative difference of a step's total loss.
* ``grad_gap``: over the leaves, the gap between the norms of the first
  gradient as the optimizer holds it, against the larger of the
  reference leaf's norm and the median leaf's.
* ``update_gap``: the same for the parameters' change over the steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's are nought to rounding (a bias ahead of a normalisation) and are
left out of both, by that rule and not by name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

from ..reference.decode import decode


SMALL_LEAF = 1e-3


def _worse(a: float, b: float) -> float:
    """The larger of two gaps, infinite where either is not a number."""
    return math.inf if math.isnan(a) or math.isnan(b) else max(a, b)


def _cells(boxes: torch.Tensor, bounds, hw) -> Tuple[torch.Tensor, torch.Tensor]:
    x_min, x_max, y_min, y_max = bounds
    H, W = hw
    rx, ry = (x_max - x_min) / W, (y_max - y_min) / H
    ix = torch.floor((boxes[..., 0] - x_min) / rx).clamp(0, W - 1).long()
    iy = torch.floor((boxes[..., 1] - y_min) / ry).clamp(0, H - 1).long()
    return ix, iy


def _own_cells(heat: torch.Tensor, scores: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor):
    """The cell of each detection: of the cell under its box's centre and
    the eight around it, the one where the program's own heatmap holds the
    detection's score (the decode reads the score there and puts the centre
    inside that cell); -1 where none does."""
    H, W = heat.shape
    found_x, found_y = torch.full_like(ix, -1), torch.full_like(iy, -1)
    for dy in (0, -1, 1):
        for dx in (0, -1, 1):
            cx, cy = (ix + dx).clamp(0, W - 1), (iy + dy).clamp(0, H - 1)
            hit = (heat[cy, cx] == scores) & (found_x < 0)
            found_x, found_y = torch.where(hit, cx, found_x), torch.where(hit, cy, found_y)
    return found_x, found_y


def _unexplained_peak(heat: torch.Tensor, kept: torch.Tensor, bounds, conf: float, nms: float, max_dets: int) -> float:
    """How far above the threshold the highest peak of the program's own
    heatmap lies that its decode dropped with no cause: a 3 x 3 local
    maximum above ``conf``, among the ``max_dets`` highest peaks, with no
    kept detection near enough (``nms`` plus a cell's diagonal from the
    cell's centre) to have suppressed it. 0 when every peak is explained."""
    H, W = heat.shape
    x_min, x_max, y_min, y_max = bounds
    rx, ry = (x_max - x_min) / W, (y_max - y_min) / H
    pooled = torch.nn.functional.max_pool2d(heat[None, None], 3, 1, 1)[0, 0]
    peak = (heat == pooled) & (heat > conf)
    vals = heat[peak]
    if vals.numel() == 0:
        return 0.0
    iy, ix = peak.nonzero(as_tuple=True)
    order = torch.sort(vals, descending=True, stable=True).indices[:max_dets]
    vals, iy, ix = vals[order], iy[order], ix[order]
    centre = torch.stack([x_min + (ix + 0.5) * rx, y_min + (iy + 0.5) * ry], dim=-1)
    if len(kept):
        near = torch.cdist(centre.double(), kept.double()).min(dim=1).values < nms + math.hypot(rx, ry)
        vals = vals[~near]
    return float((vals - conf).max()) if vals.numel() else 0.0


def _left_out(heat: torch.Tensor, ref_det: Dict[str, torch.Tensor], kept: torch.Tensor, W: int, reach: float) -> float:
    """How far, in logits, the program's heatmap ``heat`` lies below the
    reference's score at the worst of the reference's detections ``ref_det``
    (one frame's decode) that no kept detection of the program's lies
    within ``reach`` metres of; 0 when there is none."""
    sel = ref_det["valid"].nonzero().flatten()
    if not len(sel):
        return 0.0
    centres, scores, at = ref_det["boxes"][sel, :2], ref_det["scores"][sel], ref_det["cells"][sel]
    if len(kept):
        far = ~(torch.cdist(centres.double(), kept.double()).min(dim=1).values < reach)
        scores, at = scores[far], at[far]
    if not len(scores):
        return 0.0
    s, h = scores.double(), heat[at // W, at % W].double()
    if bool(h.isnan().any()):
        return math.inf
    short = torch.where(h >= s, torch.zeros_like(s), torch.logit(s) - torch.logit(h))
    return max(float(short.max()), 0.0)


def serving_numbers(prog: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]], cfg: Dict) -> Dict[str, float]:
    """``prog``: per request the program's 'boxes', 'scores', 'valid',
    'heatmap'; ``ref``: per request the reference's 'heatmap', 'offset',
    'size' maps. Returns the numbers and, for the record, the mean
    detections a frame; with no request to judge every number is NaN, so
    that a run that answered nothing is not correct."""
    if not prog:
        return dict.fromkeys(("heatmap_gap", "heatmap_rms", "det_gap", "missed_gap", "recall_gap", "dets_per_frame"),
                             math.nan)
    m, e = cfg["MODEL"], cfg["EVAL"]
    bounds = tuple(m["BEV_BOUNDS"])
    H, W = m["BEV_SIZE"][-2:]
    rx, ry = (bounds[1] - bounds[0]) / W, (bounds[3] - bounds[2]) / H
    conf, nms = e["CONF_THRESH"], e["NMS_DIST_M"]
    hm_gap = det_gap = missed_gap = recall_gap = 0.0
    n_det = n_frames = 0
    sq, cells = 0.0, 0
    for p, r in zip(prog, ref):
        hp = p["heatmap"].float().cpu()[..., 0]
        hr, off, size = (r[k].float().cpu() for k in ("heatmap", "offset", "size"))
        hr = hr[..., 0]
        d = (hp - hr).double()
        hm_gap = _worse(hm_gap, float(d.abs().max()))
        sq, cells = sq + float((d * d).sum()), cells + d.numel()
        boxes, scores, valid = p["boxes"].float().cpu(), p["scores"].float().cpu(), p["valid"].cpu().bool()
        ix, iy = _cells(boxes, bounds, (H, W))
        ref_det = decode(hr, off, size, bounds=bounds, conf=conf, nms_dist_m=nms, max_dets=e["MAX_DETS"])
        for b in range(hp.shape[0]):
            n_frames += 1
            sel = valid[b].nonzero().flatten()
            n_det += len(sel)
            if len(sel):
                jx, jy = _own_cells(hp[b], scores[b, sel], ix[b, sel], iy[b, sel])
                if bool((jx < 0).any()):  # a score found nowhere near its box on the program's own map
                    det_gap = math.inf
                    jx, jy = jx.clamp(min=0), jy.clamp(min=0)
                s_ref = hr[b, jy, jx]
                o_ref, z_ref = off[b, jy, jx], size[b, jy, jx]
                cx_ref = bounds[0] + (jx + o_ref[:, 0]) * rx
                cy_ref = bounds[2] + (jy + o_ref[:, 1]) * ry
                w_ref, h_ref = z_ref[:, 0] * rx, z_ref[:, 1] * ry
                bx = boxes[b, sel]
                gaps = torch.stack([(scores[b, sel] - s_ref).abs(), (bx[:, 0] - cx_ref).abs() / rx,
                                    (bx[:, 1] - cy_ref).abs() / ry, (bx[:, 2] / w_ref - 1).abs(),
                                    (bx[:, 3] / h_ref - 1).abs()])
                det_gap = _worse(det_gap, float(gaps.max()))
            missed_gap = max(missed_gap, _unexplained_peak(hp[b], boxes[b, sel, :2], bounds, conf, nms,
                                                           e["MAX_DETS"]))
            recall_gap = _worse(recall_gap, _left_out(hp[b], {k: v[b] for k, v in ref_det.items()}, boxes[b, sel, :2],
                                                      W, nms + math.hypot(rx, ry)))
    return {"heatmap_gap": hm_gap, "heatmap_rms": math.sqrt(sq / max(cells, 1)), "det_gap": det_gap,
            "missed_gap": missed_gap, "recall_gap": recall_gap,
            "dets_per_frame": n_det / max(n_frames, 1)}


def _median(norms) -> float:
    """The median norm of the leaves the loss reaches (a leaf past the
    level the encoder returns gets no gradient at all)."""
    reached = sorted(v for v in norms if v > 0)
    return reached[len(reached) // 2] if reached else 0.0


def _leaf_gaps(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor], keep, med: float) -> Dict[str, float]:
    """Each kept leaf's |norm(prog) - norm(ref)| / max(norm(ref), med)."""
    out = {}
    for k in keep:
        r = float(ref[k].float().norm())
        out[k] = abs(float(prog[k].float().norm()) - r) / max(r, med, 1e-30)
    return out


def _worst_and_median(gaps: Dict[str, float]) -> Tuple[float, float, str]:
    vals = sorted(gaps.values())
    if not vals or not all(math.isfinite(v) for v in vals):
        return math.inf, math.inf, ""
    return vals[-1], vals[len(vals) // 2], max(gaps, key=gaps.get)


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, object]:
    """``prog`` / ``ref``: 'losses' (the first steps' total losses), 'grad'
    (the first gradient by leaf, as the optimizer holds it) and 'update'
    (each leaf's change over the steps)."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    finite = all(math.isfinite(x) for x in losses)
    rn = {k: float(v.float().norm()) for k, v in ref["grad"].items()}
    med = _median(rn.values())
    keep = [k for k, v in rn.items() if v >= SMALL_LEAF * med and v > 0]
    un = {k: float(ref["update"][k].float().norm()) for k in keep}
    g_worst, g_med, g_leaf = _worst_and_median(_leaf_gaps(prog["grad"], ref["grad"], keep, med))
    u_worst, u_med, u_leaf = _worst_and_median(_leaf_gaps(prog["update"], ref["update"], keep, _median(un.values())))
    return {"loss_gap": max(losses) if finite else math.inf, "loss_first_gap": losses[0] if finite else math.inf,
            "grad_gap": g_worst, "grad_gap_median": g_med, "update_gap": u_worst, "update_gap_median": u_med,
            "leaves_kept": len(keep), "leaves": len(rn), "grad_leaf": g_leaf, "update_leaf": u_leaf}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every limited number finite and within its limit; the checks by name."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = float(numbers.get(name, math.nan))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
