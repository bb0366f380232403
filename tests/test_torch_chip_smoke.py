"""chip_smoke.py leaves no process running when it ends: its
``stop_children`` stops the multiprocessing resource tracker that a spawn
pool leaves behind, a child still running, and a grandchild orphaned by
its parent (adopted through ``adopt_orphans``), one that ignores SIGTERM.

It runs in a child interpreter, so that the subreaper setting and the
stopping touch no process of the test runner."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_RUN = """
import multiprocessing as mp, os, pathlib, subprocess, sys, time
from concurrent.futures import ProcessPoolExecutor
import chip_smoke

chip_smoke.adopt_orphans()
with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
    assert list(pool.map(abs, [-2])) == [2]
from multiprocessing import resource_tracker
tracker = resource_tracker._resource_tracker._pid
child = subprocess.Popen(["sleep", "300"], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
orphan = int(subprocess.run(["bash", "-c", "(trap '' TERM; exec sleep 301) >/dev/null 2>&1 & echo $!"],
                            capture_output=True, text=True, check=True).stdout)
deadline = time.monotonic() + 10
while orphan not in chip_smoke.child_pids() and time.monotonic() < deadline:
    time.sleep(0.05)
before = sorted(chip_smoke.child_pids())
chip_smoke.stop_children()
alive = [pid for pid in (tracker, child.pid, orphan) if pathlib.Path(f"/proc/{pid}").exists()]
print(tracker is not None, sorted([tracker, child.pid, orphan]) == before, alive, chip_smoke.child_pids())
"""


def test_stop_children_leaves_no_process():
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the tracker ran, the three were children before, none is alive after, and no child is left
    assert proc.stdout.strip().splitlines()[-1] == "True True [] []", proc.stdout + proc.stderr[-3000:]
    assert "SIGKILL to child process" in proc.stderr  # the orphan ignored SIGTERM
