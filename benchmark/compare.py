"""The comparison that decides `correct`: what the timed path produced in
the checked blocks against the plain reference's decode of the same
blocks.

Numbers compared, each against its limit in `limits/<workload>.json`:
  detect_diff   values of the detector's output that differ: every
                integer field (the gone rows' id, start, stop, last and
                bin; the active bursts' flags, ids, starts, ends and
                masks; the scalar counters) and the noise history and its
                sum, bit for bit.
  db_gap        the widest relative gap of its dB fields (the gone rows'
                and active bursts' magnitude and noise, the peak): the
                card's log10 against the host's.
  lines_off     share of lines (the larger side's count) that are
                unpaired (a burst id with a line on one side only: the
                block's n_ok) or differ beyond the rule (any field but
                the frequency and the level, the frequency by more than
                1 Hz, the level by more than one in its last printed
                digit).
  level_gap     median over paired frames of |level - reference level| /
                reference level, at full precision: the steady measure of
                the class batches' arithmetic (the front-end's FIR above
                all).
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

NUMBERS = ("detect_diff", "db_gap", "lines_off", "level_gap")
EXACT_PLANES = ("baseline_hist", "baseline_sum", "a_valid", "a_id",
                "a_start", "a_last", "mask_count", "ints")
EXACT_GONE = ("g_id", "g_start", "g_stop", "g_last", "g_bin")
DB_PLANES = ("a_mag", "a_noise", "floats")
DB_GONE = ("g_mag", "g_noise")


def load_limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        return json.load(f)["limits"]


def _differ(a, b) -> int:
    """Values of two tensors that differ (f32 by their bits)."""
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _rel_gap(a, b) -> float:
    """The widest |a - b| / |b| of two f32 tensors (0 where both are 0)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    if a.numel() == 0:
        return 0.0
    d = (a - b).abs() / b.abs().clamp(min=1e-30)
    return float(d.max())


def detect_numbers(prog, ref) -> tuple[int, float]:
    """(differing exact values, widest dB gap) of the program's detector
    output `prog` against the reference's `ref` (fields by name)."""
    n = int(ref.ints[7])
    diff = sum(_differ(getattr(prog, f), getattr(ref, f))
               for f in EXACT_PLANES)
    diff += sum(_differ(getattr(prog, f)[:n], getattr(ref, f)[:n])
                for f in EXACT_GONE)
    gap = max([_rel_gap(getattr(prog, f), getattr(ref, f))
               for f in DB_PLANES]
              + [_rel_gap(getattr(prog, f)[:n], getattr(ref, f)[:n])
                 for f in DB_GONE])
    return diff, gap


def parse_line(line: str) -> dict:
    """The fields of a `RAW:` line."""
    t = line.split()
    return dict(info=t[1], ts=t[2], freq=int(t[3]), n=t[4], id=t[5],
                conf=t[6], level=float(t[7]), payload=t[8],
                bits=t[9] if len(t) > 9 else "")


def beyond_rule(a: dict, b: dict) -> bool:
    if abs(a["freq"] - b["freq"]) > 1:
        return True
    if abs(a["level"] - b["level"]) > 1.5e-5:
        return True
    return any(a[k] != b[k] for k in ("info", "ts", "n", "id", "conf",
                                      "payload", "bits"))


def lines_numbers(prog: list, ref: list) -> dict:
    """prog, ref: [(line, frame)] of the same blocks -> counts and gaps."""
    pa = {f["id"]: (parse_line(ln), f) for ln, f in prog}
    ra = {f["id"]: (parse_line(ln), f) for ln, f in ref}
    both = sorted(set(pa) & set(ra))
    gaps = [abs(pa[i][1]["level"] - ra[i][1]["level"])
            / max(abs(ra[i][1]["level"]), 1e-30) for i in both]
    return dict(
        lines=max(len(pa), len(ra)), paired=len(both),
        unpaired=len(set(pa) ^ set(ra)),
        beyond=sum(beyond_rule(pa[i][0], ra[i][0]) for i in both),
        gaps=gaps)


def numbers(detect: list, parts: list) -> dict:
    """The numbers compared, from the `detect_numbers` and the
    `lines_numbers` of each checked block."""
    lines = sum(p["lines"] for p in parts)
    paired = sum(p["paired"] for p in parts)
    gaps = [g for p in parts for g in p["gaps"]]
    return dict(
        detect_diff=sum(d for d, _ in detect),
        db_gap=max((g for _, g in detect), default=0.0),
        lines_off=sum(p["unpaired"] + p["beyond"] for p in parts)
        / max(lines, 1),
        level_gap=float(np.median(gaps)) if gaps else 0.0,
        lines=lines, paired=paired)


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and {number: {"value", "limit"}} of the numbers compared."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    if nums["lines"] == 0:
        ok = False
    return ok, checks
