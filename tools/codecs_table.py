"""Per-stream codec size table on the flagship bench streams (VERDICT r04
missing #3 / weak #4: the number that decides how big the device-entropy
size tax is).

Usage: python tools/codecs_table.py <archive.mtc> [out.json]

For every stream in the archive, trial-encodes the HOST family
(o1rc/o2rc/dnarc/dz/xz as applicable) and the DEVICE family (trans,
trans1/trans2, dzt), records sizes, then totals two archive variants:
* host_archive_bytes  — the `auto` winners (what the product path ships)
* device_archive_bytes — the best DEVICE-eligible codec per stream (store/
  raw fallback where the device family loses to raw), i.e. what a
  deployment pays when the entropy stage runs on the device.

Sizes are backend-independent (the codecs are deterministic); this runs on
the CPU backend so the table is cheap to regenerate.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np  # noqa: F401
    from minicom_tpu.io import container
    from minicom_tpu.entropy import backend

    arc = sys.argv[1]
    out_json = sys.argv[2] if len(sys.argv) > 2 else None
    meta, streams = container.read_container(arc)
    host_cands = {
        "ref": ["dz", "dnarc"], "single": ["dz", "dnarc"],
        "diff": ["o2rc", "o1rc"], "nsingle": ["o1rc"],
        "dpos": ["p2:o1rc"], "cnt": ["p4:xz"], "dposx": ["p4:xz"],
    }
    dev_cands = {
        "ref": ["dzt"], "single": ["dzt"],
        "diff": ["trans2", "trans1"], "nsingle": ["trans2", "trans1"],
        "dpos": ["p2:trans1"], "cnt": ["p4:trans1"], "dposx": ["p4:trans1"],
    }
    rows = {}
    host_total = dev_total = 0
    for name in sorted(streams):
        raw = streams[name]
        if not raw:
            continue
        row = {"raw": len(raw)}
        for fam, cands in (("host", host_cands.get(name, ["o1rc", "xz"])),
                           ("device", dev_cands.get(name, ["trans1"]))):
            best = ("store", len(raw))
            for c in cands + ["store"]:
                if not backend.available(c):
                    continue
                t0 = time.time()
                n = len(backend.compress(c, raw))
                row[c] = n
                row[c + "_enc_s"] = round(time.time() - t0, 2)
                if n < best[1]:
                    best = (c, n)
            row[fam + "_best"] = best[0]
            row[fam + "_bytes"] = best[1]
        host_total += row["host_bytes"]
        dev_total += row["device_bytes"]
        rows[name] = row
        print(name, json.dumps(row), flush=True)

    result = {
        "what": ("Per-stream host vs on-chip codec sizes on the flagship "
                 "bench archive; device_archive = every stream through the "
                 "device rANS family (trans/trans1/trans2/dzt)"),
        "archive": os.path.basename(arc),
        "streams": rows,
        "host_archive_stream_bytes": host_total,
        "device_archive_stream_bytes": dev_total,
        "device_vs_host": round(dev_total / host_total, 4),
        "gate_device_within_5pct": dev_total <= host_total * 1.05,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "streams"}))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
