"""Profile count+build at full width on the GPU and attribute device time.

Runs the headline count+build of bench.py (extract -> canonical -> count ->
build on the E. coli-scale clean reads, pre-staged on the device) once to
compile, once more under `jax.profiler.trace`, and reduces the trace:
every device event is mapped, through the compiled HLO, to the ops it
executes and so to a category:

  compact — ops under the `compact` named scope (kernels/compact.py:
            the prefix sum and the scatter of the stream compaction)
  sort    — sort ops (and XLA's sort custom calls)
  other   — everything else

Prints one JSON line: device time per category and per phase, the share
of each, the busy window, the top kernels with their ops, and the card's
name and power limit. Writes the HLO and the trace under `--out`.

Usage: python scripts/trace_count_build.py [--scale 1.0] [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")


def hlo_op_names(hlo_text: str) -> dict[str, set[str]]:
    """instruction name -> op_name metadata of it and of what it calls."""
    own: dict[str, set[str]] = {}
    calls: dict[str, list[str]] = {}
    comp_ops: dict[str, set[str]] = {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            comp_ops.setdefault(comp, set())
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name, rest = m.groups()
        ops = set(_OPNAME.findall(rest))
        head = rest.split("(")[0].split()
        if (head and head[-1] == "sort") or (
                "custom-call" in rest and "sort" in rest.lower()):
            ops.add("<sort>")
        own[name] = ops
        calls[name] = _CALLS.findall(rest)
        if comp is not None:
            comp_ops[comp].update(ops)
    out = {n: ops.union(*(comp_ops.get(c, set()) for c in calls[n]))
           for n, ops in own.items()}
    # GPU kernels are named after their instruction with '.' -> '_'
    for n in list(out):
        out.setdefault(re.sub(r"[.\-]", "_", n), out[n])
    return out


def category(ops: set[str]) -> str:
    if any("/compact/" in o or o.endswith("/compact") for o in ops):
        return "compact"
    if any(o == "<sort>" or "sort" in o.rsplit("/", 1)[-1] for o in ops):
        return "sort"
    return "other"


def _stats(ev) -> dict:
    out = {}
    for s in ev.stats:
        try:
            k, v = s
        except (TypeError, ValueError):
            continue
        out[str(k)] = v
    return out


def reduce_trace(xplane: str, hlo: dict[str, dict[str, set[str]]]) -> dict:
    """Device events -> time per category / phase (module)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane)
    cat_ns: dict[str, float] = {}
    mod_ns: dict[str, float] = {}
    per_kernel: dict[str, list] = {}
    spans = []
    unmatched = 0
    samples: list[dict] = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = _stats(ev)
                op = str(st.get("hlo_op", ev.name))
                module = str(st.get("hlo_module", ""))
                mod_key = next((k for k in hlo if k in module), None)
                tables = [hlo[mod_key]] if mod_key else list(hlo.values())
                ops = next((t[op] for t in tables if op in t), None)
                if len(samples) < 60:
                    samples.append(dict(line=line.name, name=ev.name,
                                        ns=float(ev.duration_ns),
                                        stats={a: str(b)[:120]
                                               for a, b in st.items()}))
                if ops is None:
                    unmatched += 1
                    ops = set()
                c = category(ops)
                d = float(ev.duration_ns)
                cat_ns[c] = cat_ns.get(c, 0.0) + d
                mod_ns[mod_key or module] = mod_ns.get(mod_key or module,
                                                       0.0) + d
                k = per_kernel.setdefault(f"{mod_key or module}:{op}",
                                          [0.0, c, sorted(ops)[:3]])
                k[0] += d
                spans.append((float(ev.start_ns), float(ev.start_ns) + d))
    total = sum(cat_ns.values())
    spans.sort()
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur:
        busy += cur[1] - cur[0]
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    return dict(
        kernel_ns_total=total,
        ns_by_category=cat_ns,
        share_by_category={c: v / total for c, v in cat_ns.items()} if total
        else {},
        ns_by_phase=mod_ns,
        busy_ns=busy, window_ns=window,
        idle_share=(1 - busy / window) if window else None,
        events_unmatched=unmatched, events=len(spans),
        top_kernels=[dict(op=o, ns=v[0], category=v[1], ops=v[2])
                     for o, (v) in top],
        sample_events=samples)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace_count_build"))
    args = ap.parse_args()
    from genome_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from genome_tpu.graph.build import build_graph_device
    from genome_tpu.io.benchdata import bench_workload
    from genome_tpu.kernels.count import count_kmers_device
    from genome_tpu.kernels.extract import extract_canonical_kmers

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX platform is {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    os.makedirs(args.out, exist_ok=True)

    w = bench_workload(args.scale)
    k, capacity = w["k"], w["capacity"]

    @jax.jit
    def count(codes):
        his, los = extract_canonical_kmers(codes, k)
        res = count_kmers_device(his, los, 2, capacity)
        return res["table_hi"], res["table_lo"], res["n_unique"]

    @jax.jit
    def build(th, tl, n):
        return build_graph_device(th, tl, n, k)[0]

    codes = jnp.asarray(w["clean"])
    th, tl, n_uni = count(codes)
    n = int(n_uni)
    step = max(256, 1 << max(0, n.bit_length() - 6))
    cap2 = min(capacity, -(-n // step) * step)
    jax.block_until_ready(build(th[:cap2], tl[:cap2], n_uni))

    hlo = {}
    for name, fn, a in (("count", count, (codes,)),
                        ("build", build, (th[:cap2], tl[:cap2], n_uni))):
        text = fn.lower(*a).compile().as_text()
        with open(os.path.join(args.out, f"{name}.hlo.txt"), "w") as f:
            f.write(text)
        hlo[f"jit_{name}"] = hlo_op_names(text)

    tdir = os.path.join(args.out, "trace")
    with jax.profiler.trace(tdir):
        th, tl, n_uni = count(codes)
        int(n_uni)
        jax.block_until_ready(build(th[:cap2], tl[:cap2], n_uni))
    xplane = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                              recursive=True))[-1]
    rec = dict(card=card, device_kind=dev.device_kind,
               n_windows=w["n_windows"], n_unique=n, cap2=cap2,
               **reduce_trace(xplane, hlo))
    with open(os.path.join(args.out, "reduced.json"), "w") as f:
        json.dump(rec, f, indent=1)
    rec.pop("sample_events")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
