"""The host CPU as lscpu (else /proc/cpuinfo) names it, for the host
times that chip_smoke.py's phase 21 and tools/bvh_build_times.py print.

    python tools/host_cpu.py
"""

from __future__ import annotations

import os
import platform
import subprocess


def host_cpu():
    """The host CPU as lscpu (else /proc/cpuinfo) names it: its model
    name, vendor, family / model numbers and architecture where given,
    and the core count, for the host times."""
    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    for line in out.splitlines():
        key, _, val = line.partition(":")
        fields.setdefault(key.strip().lower(), val.strip())
    if not out:
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    key, _, val = line.partition(":")
                    fields.setdefault(key.strip().lower(), val.strip())
        except OSError:
            pass
    parts = [f"{k} {fields[k]}" for k in ("model name", "vendor id",
                                          "vendor_id", "cpu family",
                                          "model") if fields.get(k)]
    return ", ".join([fields.get("architecture", platform.machine())]
                     + parts + [f"{os.cpu_count()} cores"])


if __name__ == "__main__":
    print(host_cpu())
