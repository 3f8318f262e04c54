"""Static-HTML hyperparameter explorer (the reference's HiPlot role,
without the hiplot dependency or a server).

Port of ``brainmagick_tpu/grids/explore.py``: ``export_html`` renders a
grid's (overrides x metrics) rows, the metrics read from each XP's
history-torch.json, into ONE self-contained HTML file: an interactive
parallel-coordinates plot (axis brushing to filter, color-by-metric,
hover/click highlighting) plus a sortable table, in vanilla JS/SVG, so
it opens from disk on a host with no network.

CLI: ``python -m brainmagick_tpu_torch.grids <grid> --html [--out_dir=...]``
"""

from __future__ import annotations

import ast
import html
import json
import typing as tp
from pathlib import Path

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>grid: __NAME__</title>
<style>
 body { font: 13px system-ui, sans-serif; margin: 16px; color: #222; }
 h1 { font-size: 16px; }
 svg { user-select: none; }
 .line { fill: none; stroke-width: 1.2; opacity: 0.75; }
 .line.dim { stroke: #ccc !important; opacity: 0.25; }
 .line.hot { stroke-width: 3; opacity: 1; }
 .axis line { stroke: #888; }
 .axis text { font-size: 10px; fill: #444; }
 .axis .label { font-size: 11px; font-weight: 600; cursor: pointer; }
 .brush { fill: #4682b4; opacity: 0.25; cursor: ns-resize; }
 table { border-collapse: collapse; margin-top: 16px; }
 th, td { border: 1px solid #ddd; padding: 3px 8px; font-size: 12px; }
 th { cursor: pointer; background: #f5f5f5; }
 tr.hot { background: #fff3c4; }
 tr.dim { color: #bbb; }
 #controls { margin: 8px 0; }
</style></head><body>
<h1>grid __NAME__ &mdash; __NROWS__ runs</h1>
<div id="controls">color by
 <select id="colorby"></select>
 <button id="clear">clear brushes</button>
 <span id="count"></span></div>
<svg id="pc" width="__WIDTH__" height="360"></svg>
<div id="tablebox"></div>
<script>
const DATA = __DATA__;
const COLUMNS = __COLUMNS__;
const W = __WIDTH__, H = 360, TOP = 48, BOT = 24;
const svg = document.getElementById('pc');
const NS = 'http://www.w3.org/2000/svg';
const isNum = c => DATA.some(r => r[c] !== null && r[c] !== undefined)
  && DATA.every(r => r[c] === null || r[c] === undefined
                || typeof r[c] === 'number');
const scales = {}, brushes = {};
function categories(c) {
  return [...new Set(DATA.map(r => String(r[c])))].sort();
}
COLUMNS.forEach(c => {
  if (isNum(c)) {
    const vals = DATA.map(r => r[c]).filter(v => v !== null && v !== undefined);
    let lo = Math.min(...vals), hi = Math.max(...vals);
    if (lo === hi) { lo -= 1; hi += 1; }
    scales[c] = v => TOP + (H - TOP - BOT) * (1 - (v - lo) / (hi - lo));
    scales[c].lo = lo; scales[c].hi = hi; scales[c].numeric = true;
  } else {
    const cats = categories(c);
    scales[c] = v => TOP + (H - TOP - BOT) *
      (cats.length < 2 ? 0.5 : 1 - cats.indexOf(String(v)) / (cats.length - 1));
    scales[c].cats = cats; scales[c].numeric = false;
  }
});
const ax = c => 40 + COLUMNS.indexOf(c) * ((W - 80) / Math.max(1, COLUMNS.length - 1));
// viridis-ish ramp
function color(t) {
  const stops = [[68,1,84],[59,82,139],[33,145,140],[94,201,98],[253,231,37]];
  t = Math.max(0, Math.min(1, t)); const i = Math.min(3, Math.floor(t * 4));
  const f = t * 4 - i, a = stops[i], b = stops[i + 1];
  return `rgb(${a.map((v,k)=>Math.round(v+f*(b[k]-v))).join(',')})`;
}
const numericCols = COLUMNS.filter(c => scales[c].numeric);
const sel = document.getElementById('colorby');
numericCols.forEach(c => {
  const o = document.createElement('option'); o.value = o.textContent = c;
  sel.appendChild(o);
});
const metricDefault = numericCols.filter(c => c.includes('.')).pop();
if (metricDefault) sel.value = metricDefault;
function rowColor(r) {
  const c = sel.value; if (!c) return '#4682b4';
  const s = scales[c], v = r[c];
  if (v === null || v === undefined) return '#999';
  return color((v - s.lo) / (s.hi - s.lo || 1));
}
function pass(r) {
  return COLUMNS.every(c => {
    const b = brushes[c]; if (!b) return true;
    const y = r[c] === null || r[c] === undefined ? null : scales[c](r[c]);
    return y !== null && y >= b[0] && y <= b[1];
  });
}
const lines = [];
function redraw() {
  let n = 0;
  DATA.forEach((r, i) => {
    const ok = pass(r);
    lines[i].setAttribute('stroke', rowColor(r));
    lines[i].classList.toggle('dim', !ok);
    const tr = document.getElementById('tr' + i);
    if (tr) tr.classList.toggle('dim', !ok);
    if (ok) n++;
  });
  document.getElementById('count').textContent = n + ' / ' + DATA.length + ' selected';
}
DATA.forEach((r, i) => {
  const pts = COLUMNS.filter(c => r[c] !== null && r[c] !== undefined)
    .map(c => ax(c) + ',' + scales[c](r[c])).join(' ');
  const el = document.createElementNS(NS, 'polyline');
  el.setAttribute('points', pts); el.setAttribute('class', 'line');
  el.addEventListener('mouseenter', () => hot(i, true));
  el.addEventListener('mouseleave', () => hot(i, false));
  svg.appendChild(el); lines.push(el);
});
function hot(i, on) {
  lines[i].classList.toggle('hot', on);
  const tr = document.getElementById('tr' + i);
  if (tr) tr.classList.toggle('hot', on);
}
COLUMNS.forEach(c => {
  const g = document.createElementNS(NS, 'g'); g.setAttribute('class', 'axis');
  const x = ax(c);
  const line = document.createElementNS(NS, 'line');
  line.setAttribute('x1', x); line.setAttribute('x2', x);
  line.setAttribute('y1', TOP); line.setAttribute('y2', H - BOT);
  g.appendChild(line);
  const lab = document.createElementNS(NS, 'text');
  lab.setAttribute('x', x); lab.setAttribute('y', TOP - 28);
  lab.setAttribute('text-anchor', 'middle'); lab.setAttribute('class', 'label');
  lab.textContent = c; g.appendChild(lab);
  const fmt = v => typeof v === 'number' ? (Math.abs(v) >= 100 ? v.toFixed(0) : v.toPrecision(3)) : v;
  const ticks = scales[c].numeric ? [scales[c].hi, scales[c].lo]
    : scales[c].cats.slice(0, 8);
  ticks.forEach(t => {
    const ty = scales[c].numeric ? scales[c](t) : scales[c](t);
    const tx = document.createElementNS(NS, 'text');
    tx.setAttribute('x', x + 3); tx.setAttribute('y', ty + 3);
    tx.textContent = fmt(t); g.appendChild(tx);
  });
  // ns-drag on the axis creates a brush filter. Coordinates come from
  // clientY relative to the svg box: offsetY is relative to whatever
  // element sits under the cursor (polyline, table, ...), which is not
  // the scale space scales[c] lives in.
  const svgY = ev => ev.clientY - svg.getBoundingClientRect().top;
  let y0 = null, rect = null;
  line.addEventListener('mousedown', e => {
    y0 = svgY(e);
    rect = document.createElementNS(NS, 'rect');
    rect.setAttribute('x', x - 6); rect.setAttribute('width', 12);
    rect.setAttribute('class', 'brush'); g.appendChild(rect);
    const move = ev => {
      const y1 = svgY(ev), lo = Math.min(y0, y1), hi = Math.max(y0, y1);
      rect.setAttribute('y', lo); rect.setAttribute('height', hi - lo);
      brushes[c] = [lo, hi]; redraw();
    };
    const up = () => {
      document.removeEventListener('mousemove', move);
      document.removeEventListener('mouseup', up);
      if (!brushes[c] || brushes[c][1] - brushes[c][0] < 3) {
        delete brushes[c]; if (rect) rect.remove(); redraw();
      }
    };
    document.addEventListener('mousemove', move);
    document.addEventListener('mouseup', up);
    e.preventDefault();
  });
  line.setAttribute('stroke-width', 8); line.setAttribute('stroke', '#8884');
  svg.appendChild(g);
});
document.getElementById('clear').addEventListener('click', () => {
  Object.keys(brushes).forEach(k => delete brushes[k]);
  document.querySelectorAll('.brush').forEach(b => b.remove());
  redraw();
});
sel.addEventListener('change', redraw);
// sortable table
const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;')
  .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
const box = document.getElementById('tablebox');
function buildTable(sortCol, desc) {
  const order = DATA.map((r, i) => i);
  if (sortCol) order.sort((a, b) => {
    const va = DATA[a][sortCol], vb = DATA[b][sortCol];
    if (va === vb) return 0;
    if (va === null || va === undefined) return 1;
    if (vb === null || vb === undefined) return -1;
    return (va < vb ? -1 : 1) * (desc ? -1 : 1);
  });
  let h = '<table><tr>' + COLUMNS.map(c => `<th data-c="${esc(c)}">${esc(c)}</th>`).join('') + '</tr>';
  order.forEach(i => {
    const r = DATA[i];
    h += `<tr id="tr${i}">` + COLUMNS.map(c => `<td>${r[c] === null || r[c] === undefined ? '' : esc(r[c])}</td>`).join('') + '</tr>';
  });
  box.innerHTML = h + '</table>';
  box.querySelectorAll('th').forEach(th => th.addEventListener('click', () =>
    buildTable(th.dataset.c, th.dataset.c === sortCol ? !desc : true)));
  box.querySelectorAll('tr[id]').forEach(tr => {
    const i = +tr.id.slice(2);
    tr.addEventListener('mouseenter', () => hot(i, true));
    tr.addEventListener('mouseleave', () => hot(i, false));
  });
  redraw();
}
buildTable(null, false);
redraw();
</script></body></html>
"""


def collect_rows(name: str, out_dir: str = "./outputs"
                 ) -> tp.Tuple[tp.List[dict], tp.List[str]]:
    """(rows, ordered columns) for a grid: overrides then metrics,
    numbers as numbers."""
    from .runner import get_grid, read_history

    explorer, jobs = get_grid(name)
    rows: tp.List[dict] = []
    columns: tp.List[str] = ["sig"]
    for job in jobs:
        sig = job.sig
        row: tp.Dict[str, tp.Any] = {"sig": sig}
        for k, v in job.overrides.items():
            if isinstance(v, str):
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
            row[k] = v if isinstance(v, (int, float, bool)) else repr(v)
        history = read_history(out_dir, sig)
        if history is not None:
            for stage, metrics in explorer.process_history(history).items():
                for key, val in metrics.items():
                    if isinstance(val, (int, float)):
                        row[f"{stage}.{key}"] = val
        for k in row:
            if k not in columns:
                columns.append(k)
        rows.append(row)
    return rows, columns


def export_html(name: str, out_dir: str = "./outputs",
                dest: tp.Optional[str] = None) -> Path:
    """One self-contained interactive HTML for a grid's runs."""
    rows, columns = collect_rows(name, out_dir)
    data = [{c: r.get(c) for c in columns} for r in rows]
    width = max(720, 120 * len(columns))
    page = (_TEMPLATE
            .replace("__NAME__", html.escape(name))
            .replace("__NROWS__", str(len(rows)))
            .replace("__WIDTH__", str(width))
            # '</' -> '<\/': a '</script>' inside a sig/override string
            # must not terminate the inline script block
            .replace("__DATA__", json.dumps(data).replace("</", "<\\/"))
            .replace("__COLUMNS__",
                     json.dumps(columns).replace("</", "<\\/")))
    dest_path = Path(dest or (Path(out_dir) / f"grid_{name}.html"))
    dest_path.parent.mkdir(parents=True, exist_ok=True)
    dest_path.write_text(page)
    print(f"wrote {dest_path} ({len(rows)} rows, {len(columns)} columns)")
    return dest_path
