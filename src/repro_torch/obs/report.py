"""Trace-file summarizer: ``python -m repro_torch.obs.report TRACE.jsonl``.

Reads a JSONL trace written by ``obs/trace.py`` and prints:

* the commit + environment meta line the trace is keyed by;
* the per-phase wall-time summary (count, total, p50, p95), sorted by
  total descending;
* the top compile offenders — spans during which a kernel library was
  built or loaded (``kernels/build.py::load``), slowest first;
* roofline context for the phases that attach analytic ``est_flops`` /
  ``est_bytes`` attributes (train, schedule): arithmetic intensity
  against the H100's ridge point via ``launch/roofline.py`` and, from the
  measured wall time, the attained fraction of the roofline floor;
* the counter/gauge/observation snapshot.

``--json`` emits the same content as one JSON object for tooling.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.launch.roofline import intensity_context
from repro_torch.obs.trace import load_jsonl, phase_summary


def compile_offenders(spans: List[Dict], top: int = 10) -> List[Dict]:
    """Spans that built or loaded a kernel, slowest first."""
    hits = [s for s in spans if (s.get("attrs") or {}).get("compiled")]
    hits.sort(key=lambda s: s["dur"], reverse=True)
    return [{"name": s["name"], "dur_s": s["dur"],
             "attrs": {k: v for k, v in (s.get("attrs") or {}).items()
                       if k != "compiled"}}
            for s in hits[:top]]


def roofline_context(spans: List[Dict]) -> Dict[str, Dict]:
    """Aggregate est_flops/est_bytes per phase and place each phase on
    the roofline."""
    agg: Dict[str, List[float]] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        if "est_flops" in attrs and "est_bytes" in attrs:
            f, b, d = agg.setdefault(s["name"], [0.0, 0.0, 0.0])
            agg[s["name"]] = [f + attrs["est_flops"],
                              b + attrs["est_bytes"], d + s["dur"]]
    out: Dict[str, Dict] = {}
    for name, (flops, nbytes, dur) in sorted(agg.items()):
        if nbytes > 0:
            out[name] = intensity_context(flops, nbytes, measured_s=dur)
    return out


def summarize(path: str, top: int = 10) -> Dict:
    """Everything the CLI prints, as one dict."""
    meta, spans, metrics = load_jsonl(path)
    return {"meta": meta,
            "phases": phase_summary(spans),
            "compile_offenders": compile_offenders(spans, top=top),
            "roofline": roofline_context(spans),
            "metrics": metrics}


def _fmt_eng(x: float) -> str:
    for unit, scale in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(x) >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.2f}"


def render(rep: Dict, out=None) -> None:
    out = out or sys.stdout
    w = out.write
    meta = rep["meta"]
    w(f"# trace commit={meta.get('commit', '?')} "
      f"python={meta.get('python', '?')} torch={meta.get('torch', '?')} "
      f"cuda={meta.get('cuda', '?')} gpu={meta.get('gpu', 'none')} "
      f"at={meta.get('timestamp', '?')}\n")
    w("phase,count,total_s,p50_s,p95_s\n")
    phases = sorted(rep["phases"].items(),
                    key=lambda kv: kv[1]["total_s"], reverse=True)
    for name, p in phases:
        w(f"{name},{p['count']},{p['total_s']:.6f},"
          f"{p['p50_s']:.6f},{p['p95_s']:.6f}\n")
    if rep["compile_offenders"]:
        w("# top compile offenders (kernel libraries built or loaded)\n")
        for o in rep["compile_offenders"]:
            extra = "".join(f" {k}={v}" for k, v in o["attrs"].items())
            w(f"compile,{o['name']},{o['dur_s']:.6f}{extra}\n")
    if rep["roofline"]:
        w("# roofline context (analytic est_flops/est_bytes vs the H100 "
          "SXM roof)\n")
        for name, r in rep["roofline"].items():
            att = (f" attained={r['attained_frac']:.2e}"
                   if "attained_frac" in r else "")
            w(f"roofline,{name},{_fmt_eng(r['flops'])}F,"
              f"{_fmt_eng(r['hbm_bytes'])}B,"
              f"AI={r['intensity']:.2f},ridge={r['ridge']:.0f},"
              f"{r['bound']}-bound,floor={r['time_floor_s']:.3e}s{att}\n")
    m = rep.get("metrics") or {}
    for kind in ("counters", "gauges", "observations"):
        for name, v in (m.get(kind) or {}).items():
            if isinstance(v, dict):
                body = ",".join(f"{k}={v[k]:.6g}" if
                                isinstance(v[k], float) else f"{k}={v[k]}"
                                for k in sorted(v))
            else:
                body = str(v)
            w(f"metric,{kind},{name},{body}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize a repro_torch.obs JSONL trace")
    ap.add_argument("trace", help="path to a trace .jsonl file")
    ap.add_argument("--top", type=int, default=10,
                    help="compile offenders to show")
    ap.add_argument("--json", dest="as_json", action="store_true")
    args = ap.parse_args(argv)
    rep = summarize(args.trace, top=args.top)
    if args.as_json:
        print(json.dumps(rep))
    else:
        render(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
