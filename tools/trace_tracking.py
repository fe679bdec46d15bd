"""Where the device time of the RGB-D pipeline goes, from a profiler trace.

Run on the GPU, one process per card:
    python tools/trace_tracking.py [--out out/trace_tracking]

Runs bench.py's sequence once to compile and warm (plus warm_mapping()),
then traces one more full pass with jax.profiler.  Kernel events on the
device are summed per HLO module (the chunked tracking step is the module
of ``make_fused_chunk_tracker``; the rest is mapping and loop closing).
The tracking module's kernels are then classified by what they fuse, read
from the op_name metadata in the step's compiled HLO text:

  hamming  fusions that contain a population_count (the packed Hamming
           distance and whatever reduction XLA fused with it)
  fast     fusions from ops/fast.py (FAST-9 score, 3x3 NMS)
  command_buffer  kernels XLA replayed as one CUDA graph; the trace cannot
           see inside.  Run with XLA_FLAGS=--xla_gpu_enable_command_buffer=
           (a measurement setting, not the production one) to classify them.
  other    everything else

Writes summary.json under --out (the raw trace is deleted once reduced).
Prints one JSON line with the tracking-step shares.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Lines of a GPU plane that restate kernel events (not kernels themselves).
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source", "Launch Stats",
                  "TensorFlow Ops", "Framework Name Scope")


def _norm(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z]", "_", name)


def fusion_classes(hlo_text: str) -> dict:
    """{normalized instruction name: class} for every instruction of the
    compiled module whose called computation (or itself) carries op_name
    metadata of a known stage."""
    comp_ops = collections.defaultdict(set)   # computation -> op_names
    cur = None
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$",
                     line)
        if m:
            cur = m.group(1)
            continue
        if cur is not None:
            for op in re.findall(r'op_name="([^"]*)"', line):
                comp_ops[cur].add(op)
            for callee in re.findall(r"calls=%?([\w.\-]+)", line):
                comp_ops[cur].add("@" + callee)
    classes = {}
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        ops = set(re.findall(r'op_name="([^"]*)"', line))
        stack = re.findall(r"calls=%?([\w.\-]+)", line)
        seen = set()
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            for op in comp_ops.get(c, ()):
                if op.startswith("@"):
                    stack.append(op[1:])
                else:
                    ops.add(op)
        text = " ".join(ops)
        if "population_count" in text or "popcnt" in text:
            classes[_norm(m.group(1))] = "hamming"
        elif "fast_score" in text or "nms3x3" in text:
            classes[_norm(m.group(1))] = "fast"
    return classes


def device_events(trace_dir: str):
    """[(line, kernel name, stats dict, duration ns)] of the GPU planes."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    out, lines = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = (
                len(evs), sum(e.duration_ns for e in evs))
            if line.name in _DERIVED_LINES:
                continue
            for e in evs:
                out.append((line.name, e.name, dict(e.stats), e.duration_ns))
    return out, lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out/trace_tracking")
    args = ap.parse_args()

    import jax

    from bench import build, run
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    make_system, imgs, deps, _ = build()
    warm = make_system()
    run(warm, imgs, deps)
    warm.warm_mapping()

    sys_ = make_system()
    tr = sys_.tracker
    specs = {}
    get_step = tr._get_chunk_step

    def recording_get_step(sensor):
        step = get_step(sensor)

        def wrapped(*a):
            if "args" not in specs:
                specs["args"] = jax.tree.map(
                    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), a)
            return step(*a)
        specs["step"] = step
        return wrapped

    tr._get_chunk_step = recording_get_step
    raw = os.path.join(args.out, "raw")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(raw):
        run(sys_, imgs, deps)
    window_s = time.perf_counter() - t0

    hlo = specs["step"].lower(*specs["args"]).compile().as_text()
    module = re.search(r"HloModule\s+([\w.\-]+)", hlo).group(1)
    classes = fusion_classes(hlo)
    events, lines = device_events(raw)
    shutil.rmtree(raw)

    per_module = collections.Counter()
    per_kernel = collections.Counter()
    per_class = collections.Counter()
    unmatched = collections.Counter()
    for _, name, stats, dur in events:
        mod = str(stats.get("hlo_module", "?"))
        per_module[mod] += dur
        if _norm(mod) != _norm(module):
            continue
        op = str(stats.get("hlo_op", name))
        per_kernel[op] += dur
        cls = classes.get(_norm(op)) or classes.get(_norm(name))
        if cls is None and op.startswith("command_buffer"):
            cls = "command_buffer"
        per_class[cls or "other"] += dur
        if cls is None:
            unmatched[op] += dur
    step_ns = sum(per_class.values())
    shares = {k: v / step_ns for k, v in per_class.items()} if step_ns else {}
    summary = {
        "window_s": window_s,
        "frames": len(imgs),
        "tracking_module": module,
        "tracking_device_ms": step_ns / 1e6,
        "tracking_shares": shares,
        "device_ms_by_module": {k: v / 1e6 for k, v in per_module.most_common()},
        "device_busy_ms_all_kernels": sum(per_module.values()) / 1e6,
        "top_tracking_kernels_ms": {
            k: v / 1e6 for k, v in per_kernel.most_common(40)},
        "top_unclassified_ms": {
            k: v / 1e6 for k, v in unmatched.most_common(15)},
        "classified_instructions": collections.Counter(classes.values()),
        "lines": {k: {"events": n, "ms": d / 1e6} for k, (n, d) in lines.items()},
        "sample_event_stats": [
            {"line": ln, "name": nm, "stats": {k: str(v) for k, v in st.items()}}
            for ln, nm, st, _ in events[:5]],
        "device": {"kind": jax.devices()[0].device_kind},
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in (
        "tracking_module", "tracking_device_ms", "tracking_shares",
        "device_busy_ms_all_kernels", "window_s")}))


if __name__ == "__main__":
    main()
