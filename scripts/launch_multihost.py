#!/usr/bin/env python
"""Launch an N-process multihost clustering run on ONE machine.

On a real pod you run one command per host (same contract as
jax.distributed.initialize):

    python -m rabbittclust_tpu.cli.clust_mst --fast -l -i list -o out \
        --multihost host0:8476,N,PROCESS_ID

This helper spawns all N processes locally and streams their stderr.
Process 0 writes the outputs.  On real cards each process gets its own
disjoint set of this host's cards through CUDA_VISIBLE_DEVICES (a JAX
process otherwise opens every visible card and reserves most of its
memory), and more processes than cards are refused.  With
--virtual-cpu-devices M each process instead simulates M devices on the
CPU (tests and dry-runs).

Example (2-process CPU simulation, 4 virtual devices each):

    python scripts/launch_multihost.py --nproc 2 --virtual-cpu-devices 4 \
        -- --fast -l -i list.txt -o out.cluster -d 0.05
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def visible_cards() -> list:
    """This host's cards: CUDA_VISIBLE_DEVICES when set, else nvidia-smi's
    list (empty when nvidia-smi is missing or fails)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def card_sets(cards: list, nproc: int) -> list:
    """Split ``cards`` into ``nproc`` disjoint equal sets, one
    CUDA_VISIBLE_DEVICES value per process."""
    if nproc > len(cards):
        raise ValueError(f"{nproc} processes but only {len(cards)} cards "
                         f"visible; one process per card at most")
    per = len(cards) // nproc
    return [",".join(cards[i * per:(i + 1) * per]) for i in range(nproc)]


def launch(nproc: int, cli_args, module: str = "mst",
           virtual_cpu_devices: int | None = None, coordinator: str = "",
           timeout: float = 1800.0) -> int:
    port = free_port()
    coord = coordinator or f"127.0.0.1:{port}"
    procs = []
    env = dict(os.environ)
    cards = None
    if virtual_cpu_devices:
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        env["RTC_VIRTUAL_CPU_DEVICES"] = str(virtual_cpu_devices)
    else:
        cards = card_sets(visible_cards(), nproc)
    for pid in range(nproc):
        if cards is not None:
            env = dict(env, CUDA_VISIBLE_DEVICES=cards[pid])
        cmd = [sys.executable, "-m", f"rabbittclust_tpu.cli.clust_{module}",
               *cli_args, "--multihost", f"{coord},{nproc},{pid}"]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                      stderr=subprocess.PIPE, text=True))
    rc = 0
    for pid, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            print(f"process {pid} timed out", file=sys.stderr)
            return 124
        if pid == 0 or p.returncode != 0:
            sys.stderr.write(err)
        rc = rc or p.returncode
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        usage="%(prog)s --nproc N [options] -- <clust CLI args>")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--module", default="mst",
                    choices=["mst", "greedy", "leiden", "dbscan"])
    ap.add_argument("--virtual-cpu-devices", type=int, default=None)
    ap.add_argument("--coordinator", default="",
                    help="coordinator address (default: 127.0.0.1:freeport)")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="arguments forwarded to the clust CLI (prefix "
                         "with --)")
    args = ap.parse_args(argv)
    cli = args.cli_args
    if cli and cli[0] == "--":
        cli = cli[1:]
    return launch(args.nproc, cli, module=args.module,
                  virtual_cpu_devices=args.virtual_cpu_devices,
                  coordinator=args.coordinator, timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
