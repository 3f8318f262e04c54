"""Praat TextGrid reader (forced-alignment word and phoneme tiers).

Port of ``brainmagick_tpu/textgrid.py``: the long and the short TextGrid
formats, read into flat (start, stop, name, tier) interval entries.
"""

from __future__ import annotations

import re
import typing as tp
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Entry:
    start: float
    stop: float
    name: str
    tier: str


def _parse_quoted(line: str) -> str:
    m = re.search(r'"(.*)"', line)
    return m.group(1) if m else ""


def _parse_float(line: str) -> float:
    m = re.search(r"[-+0-9.eE]+\s*$", line.split("=")[-1])
    return float(m.group(0)) if m else float("nan")


def read_textgrid(filename: tp.Union[str, Path],
                  fileEncoding: str = "utf-8") -> tp.List[Entry]:
    """The interval entries of a TextGrid file, tier after tier."""
    text = Path(filename).read_text(encoding=fileEncoding, errors="replace")
    if re.search(r'"IntervalTier"', text) is None:
        raise ValueError(f"{filename} contains no IntervalTier")
    entries: tp.List[Entry] = []
    lines = text.splitlines()
    # the long format has 'item [k]:' sections
    if any(re.match(r"\s*item\s*\[", ln) for ln in lines):
        tier_name = ""
        xmin = xmax = None
        for line in lines:
            if re.match(r'\s*name\s*=', line):
                tier_name = _parse_quoted(line)
            elif re.match(r"\s*intervals\s*\[", line):
                xmin = xmax = None
            elif re.match(r"\s*xmin\s*=", line):
                xmin = _parse_float(line)
            elif re.match(r"\s*xmax\s*=", line):
                xmax = _parse_float(line)
            elif re.match(r"\s*text\s*=", line):
                if xmin is not None and xmax is not None:
                    entries.append(Entry(start=xmin, stop=xmax,
                                         name=_parse_quoted(line),
                                         tier=tier_name))
    else:
        # the short format: "IntervalTier", "name", xmin, xmax, n, then
        # n triplets (xmin, xmax, "text")
        idx = 0
        while idx < len(lines):
            if '"IntervalTier"' in lines[idx]:
                tier_name = _parse_quoted(lines[idx + 1])
                n = int(float(lines[idx + 4].strip()))
                idx += 5
                for _ in range(n):
                    start = float(lines[idx].strip())
                    stop = float(lines[idx + 1].strip())
                    name = _parse_quoted(lines[idx + 2])
                    entries.append(Entry(start=start, stop=stop, name=name,
                                         tier=tier_name))
                    idx += 3
            else:
                idx += 1
    return entries


def textgrid_to_dict(filename: tp.Union[str, Path]
                     ) -> tp.Dict[str, tp.List[Entry]]:
    """The entries by tier name (lowercased)."""
    out: tp.Dict[str, tp.List[Entry]] = {}
    for entry in read_textgrid(filename):
        out.setdefault(entry.tier.lower(), []).append(entry)
    return out
