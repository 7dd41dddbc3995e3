#!/usr/bin/env python3
"""Run ``chip_smoke.py`` and report every process it leaves behind.

    python3 scripts/check_smoke_exit.py [--dir CHECKOUT] [--out DIR]

Runs ``python3 chip_smoke.py`` from ``CHECKOUT`` (default: this repo) in
a session of its own, its standard output and errors to
``OUT/smoke.out`` / ``OUT/smoke.err`` (default ``OUT``: ``chiprun_out``),
then lists the processes still in that session, or new since the start
and still running, at 0, 1 and 5 s after it exits.  Then it copies the
script alone into an empty directory and runs it there.  Prints one JSON
line: both exit codes, the seconds, the script's last two lines, the
leftovers at each delay, and the alone run's stdout.  Exits 0 only when
the script exits 0 and leaves nothing, and the alone run exits non-zero
with nothing on stdout.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def processes():
    """``{pid: (session id, command line)}`` of every process."""
    out = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            sid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[4])
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ")
        except (OSError, IndexError, ValueError):
            continue
        out[int(d.name)] = (sid, cmd.decode(errors="replace").strip())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    before = set(processes())
    t0 = time.perf_counter()
    with open(out / "smoke.out", "w") as so, open(out / "smoke.err", "w") as se:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"],
                                cwd=args.dir, stdout=so, stderr=se,
                                start_new_session=True)
        rc = proc.wait()
    seconds = time.perf_counter() - t0
    left, waited = {}, 0
    for delay in (0, 1, 4):
        time.sleep(delay)
        waited += delay
        now = processes()
        left[waited] = [
            f"{pid} {cmd}" for pid, (sid, cmd) in sorted(now.items())
            if pid != os.getpid() and (sid == proc.pid or pid not in before)]
    with tempfile.TemporaryDirectory() as alone:
        shutil.copy(Path(args.dir) / "chip_smoke.py", alone)
        solo = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                              capture_output=True, text=True, timeout=300)
    last = (out / "smoke.out").read_text().splitlines()[-2:]
    ok = (rc == 0 and not any(left.values()) and solo.returncode != 0
          and not solo.stdout)
    print(json.dumps(dict(ok=ok, rc=rc, seconds=seconds, last_lines=last,
                          left_after_s=left, alone_rc=solo.returncode,
                          alone_stdout=solo.stdout,
                          alone_stderr=solo.stderr[-500:])))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
