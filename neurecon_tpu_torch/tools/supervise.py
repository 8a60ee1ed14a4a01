"""Training supervisor (port of `neurecon_tpu/tools/supervise.py`): run a
command under a stall and crash watchdog.

  python -m neurecon_tpu_torch.tools.supervise --stall_sec 900 --max_restarts 3 -- \
      python -m neurecon_tpu_torch.train --config configs/neus.yaml

The child's output streams through and stamps the progress clock; a child
that exits 0 ends supervision; a child that prints nothing for `stall_sec`
seconds, or exits non-zero, is killed (SIGTERM, then SIGKILL) and started
again, up to `max_restarts` times, and resumes from its newest checkpoint
(`train.py` resumes from the highest global step by itself).
`--no_restart_on_error` restarts on stalls only (e.g. for config typos).
Standard library only.
"""
from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import threading
import time

KILL_WAIT = 30.0  # seconds from SIGTERM to SIGKILL
RESTART_DELAY = 5.0  # seconds between a child's end and its restart


def supervise(cmd, stall_sec=900.0, max_restarts=3, restart_on_error=True, poll_sec=10.0,
              log=print):
    """Returns the final exit code (0: the child completed)."""
    restarts = 0
    while True:
        log(f"[supervise] start (attempt {restarts + 1}): {' '.join(cmd)}")
        last_progress = time.time()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        def pump():
            nonlocal last_progress
            for line in proc.stdout:
                last_progress = time.time()
                sys.stdout.buffer.write(line)
                sys.stdout.flush()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        stalled = False
        while proc.poll() is None:
            time.sleep(poll_sec)
            if time.time() - last_progress > stall_sec:
                log(f"[supervise] no output for >{stall_sec}s: killing pid {proc.pid}")
                stalled = True
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=KILL_WAIT)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                break
        t.join(timeout=5)
        rc = proc.returncode
        if rc == 0 and not stalled:
            log("[supervise] child completed (rc=0)")
            return 0
        if not stalled and not restart_on_error:
            log(f"[supervise] child failed rc={rc}; not restarting")
            return rc
        restarts += 1
        if restarts > max_restarts:
            log(f"[supervise] giving up after {max_restarts} restarts")
            return rc if rc is not None else 1
        log(f"[supervise] child {'stalled' if stalled else f'died rc={rc}'}; "
            f"restarting ({restarts}/{max_restarts})")
        time.sleep(RESTART_DELAY)


def main(argv=None):
    ap = argparse.ArgumentParser(
        usage="python -m neurecon_tpu_torch.tools.supervise [opts] -- "
              "python -m neurecon_tpu_torch.train --config ...")
    ap.add_argument("--stall_sec", type=float, default=900,
                    help="kill and restart if the child prints nothing this long")
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument("--no_restart_on_error", action="store_true",
                    help="only restart on stalls, not on non-zero exits")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (put it after --)")
    return supervise(cmd, stall_sec=args.stall_sec, max_restarts=args.max_restarts,
                     restart_on_error=not args.no_restart_on_error)


if __name__ == "__main__":
    sys.exit(main())
