"""A resumable measurement session on the card.

The port's counterpart of the JAX package's ``tools/tpu_measure.sh``
``stage()`` (with ``tools/run_bench_stage.py``'s rule for what completes a
stage): named stages run in a fixed order, each as a child process with
its own timeout, under an overall ``--budget``. A stage is done when its
child exits 0 AND its last JSON line names the platform the stage needs
(``"platform": "gpu"`` for a card stage; a CPU record never completes
one). Done stages are written to a state file, and a rerun skips them
unless ``--always`` is given, so a session cut short (a lost machine, a
spent budget) resumes where it stopped and its records accumulate.

    python -m distributed_point_functions_tpu_torch.tools.measure
    python -m distributed_point_functions_tpu_torch.tools.measure --stages check,variants
    python -m distributed_point_functions_tpu_torch.tools.measure --list

Stages, in order (the port's non-bench tools; the bench stages come with
the port's benchmark):

  check       ``check_device`` in every mode (``CHECK_MODE=all`` unless the
              environment names one)
  variants    the headline strategy shootout (``tools/variants.py``)
  gen-data    the sparse-histogram fixtures at 2^32 x 2^20 nonzeros (host)
  exp-hier    the experiments CLI, hierarchical, on the 0.1-skew fixture
  exp-direct  the same, direct (``--only_nonzeros``)
  soak        ``chaos_soak``, one round

Each child runs in a session of its own (``start_new_session``); one that
outlives its timeout has its whole process group killed (SIGTERM, then
SIGKILL after a grace), as the JAX package's ``tools/tpu_watch.sh`` does,
so no server or worker it started survives it. A stage's timeout is
clipped to what is left of the budget. ``--device`` is passed to every
card stage (a ``cpu`` run checks the plumbing and marks nothing done).

State lives in ``--state-dir`` (default: the package's ignored
``_build/measure/``): ``stages.state`` (one done stage a line),
``records.jsonl`` (per stage run: its name, exit code, seconds, whether it
completed, its pid and process group, and its last JSON line) and each
stage's full output in ``<stage>.log``. Exit status: 0 when every selected
stage is done, 1 when one failed or timed out, 2 when one ran cleanly but
left no record of its platform, 3 when the budget ran out first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = "distributed_point_functions_tpu_torch"
PACKAGE_DIR = Path(__file__).resolve().parent.parent
REPO = PACKAGE_DIR.parent
DEFAULT_STATE_DIR = PACKAGE_DIR / "_build" / "measure"
KILL_GRACE_SECONDS = 5.0
TAIL_LINES = 40

# The sparse-histogram stages: the reference's published size at 2^32.
EXP_LOG_DOMAIN = 32
EXP_NONZEROS = 1 << 20
EXP_SKEW = "0.1"
EXP_ITERATIONS = 3
EXP_EXPANSION_FACTOR = 4


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage: a ``python -m`` module and its arguments, its timeout,
    the platform its record must name, and its environment defaults (the
    caller's environment wins)."""

    name: str
    module: str
    args: Sequence[str] = ()
    timeout: float = 900.0
    platform: str = "gpu"  # "gpu": a card stage, given --device; "host": runs on the host
    env: Dict[str, str] = dataclasses.field(default_factory=dict)


def stages(state_dir: Path) -> List[Stage]:
    """The session's stages in their fixed order."""
    from ..experiments.gen_data import fixture_name

    data = state_dir / "data"
    fixture = str(data / fixture_name(EXP_LOG_DOMAIN, EXP_NONZEROS, EXP_SKEW))
    exp = ["--input", fixture, "--log_domain_size", str(EXP_LOG_DOMAIN),
           "--num_iterations", str(EXP_ITERATIONS),
           "--max_expansion_factor", str(EXP_EXPANSION_FACTOR)]
    return [
        Stage("check", f"{_PKG}.tools.check_device", timeout=1200,
              env={"CHECK_MODE": "all"}),
        Stage("variants", f"{_PKG}.tools.variants", timeout=600),
        Stage("gen-data", f"{_PKG}.experiments.gen_data",
              ["--log_domain_size", str(EXP_LOG_DOMAIN), "--num_nonzeros", str(EXP_NONZEROS),
               "--out_dir", str(data)], timeout=600, platform="host"),
        Stage("exp-hier", f"{_PKG}.experiments.synthetic_data_benchmarks", exp, timeout=900),
        Stage("exp-direct", f"{_PKG}.experiments.synthetic_data_benchmarks",
              exp + ["--only_nonzeros"], timeout=900),
        Stage("soak", f"{_PKG}.tools.chaos_soak", ["--rounds", "1"], timeout=900),
    ]


def last_json(text: str) -> Optional[dict]:
    """The last line of `text` that parses as a JSON object, or None."""
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if isinstance(record, dict):
                return record
    return None


def read_done(state) -> List[str]:
    """The stages a state file marks done."""
    state = Path(state)
    return state.read_text().split() if state.is_file() else []


def group_members(pgid: int) -> List[int]:
    """The pids in process group `pgid` (read from /proc; [] where there is
    no /proc)."""
    pids = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if len(fields) > 2 and fields[2] == str(pgid):
            pids.append(int(stat.parent.name))
    return sorted(pids)


def kill_group(pgid: int) -> None:
    """SIGTERM to the process group, then SIGKILL to what outlives the
    grace."""
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    t_end = time.monotonic() + KILL_GRACE_SECONDS
    while time.monotonic() < t_end:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.05)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_stage(stage: Stage, argv: List[str], timeout: float, log_path: Path,
              env: Dict[str, str]) -> dict:
    """Runs one stage's child to its end or its timeout; returns its run
    record (the record's ``done`` says whether it completed the stage)."""
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, cwd=str(REPO),
                                env=env, start_new_session=True)
        timed_out = False
        killed: List[int] = []
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            killed = group_members(proc.pid)
            kill_group(proc.pid)
            rc = proc.wait()
        # The child has exited; a straggler left in its group goes too.
        kill_group(proc.pid)
    text = log_path.read_text(errors="replace")
    record = last_json(text)
    platform = (record or {}).get("platform")
    done = not timed_out and rc == 0 and platform == stage.platform
    return {
        "stage": stage.name, "rc": rc, "timed_out": timed_out,
        "seconds": time.perf_counter() - t0, "timeout": timeout, "done": done,
        "pid": proc.pid, "pgid": proc.pid, "killed": killed, "platform": platform,
        "record": record, "log": str(log_path),
    }


def session(names: Optional[Sequence[str]] = None, budget: float = 8 * 3600,
            always: bool = False, device: Optional[str] = None,
            state_dir: Path = DEFAULT_STATE_DIR,
            timeouts: Optional[Dict[str, float]] = None,
            extra_args: Optional[Dict[str, List[str]]] = None,
            python: str = sys.executable, stage_list: Optional[List[Stage]] = None,
            say=print) -> int:
    """Runs the selected stages in order (see the module docstring); returns
    the exit status."""
    state_dir = Path(state_dir)
    state_dir.mkdir(parents=True, exist_ok=True)
    all_stages = stage_list if stage_list is not None else stages(state_dir)
    known = [s.name for s in all_stages]
    names = list(names) if names else known
    unknown = sorted(set(names) - set(known))
    if unknown:
        raise SystemExit(f"unknown stages {unknown}; known: {', '.join(known)}")
    for name in list(timeouts or {}) + list(extra_args or {}):
        if name not in known:
            raise SystemExit(f"unknown stage {name!r}; known: {', '.join(known)}")
    state = state_dir / "stages.state"
    records = state_dir / "records.jsonl"
    t_start = time.monotonic()
    say(f"=== measure: budget {budget:.0f} s, stages {','.join(names)}, resume "
        f"[{','.join(read_done(state))}], state {state_dir} ===")
    outcomes = set()  # the exit statuses of the stages that did not complete
    for stage in all_stages:
        if stage.name not in names:
            continue
        if not always and stage.name in read_done(state):
            say(f"--- stage {stage.name} done in an earlier session; skipped (resume) ---")
            continue
        left = budget - (time.monotonic() - t_start)
        if left <= 0:
            say(f"--- stage {stage.name} SKIPPED (budget {budget:.0f} s spent) ---")
            outcomes.add(3)
            continue
        tmo = (timeouts or {}).get(stage.name, stage.timeout)
        if tmo > left:
            tmo = left
            say(f"--- stage {stage.name} timeout clipped to {tmo:.0f} s (budget) ---")
        argv = [python, "-m", stage.module, *stage.args, *(extra_args or {}).get(stage.name, [])]
        if device is not None and stage.platform == "gpu":
            argv += ["--device", device]
        env = dict(stage.env)
        env.update(os.environ)
        # What a killed child leaves in its temporary directory stays here.
        env["TMPDIR"] = str(state_dir / "tmp")
        (state_dir / "tmp").mkdir(exist_ok=True)
        say(f"--- stage {stage.name} (timeout {tmo:.0f} s): {' '.join(argv[1:])} ---")
        run = run_stage(stage, argv, tmo, state_dir / f"{stage.name}.log", env)
        tail = run_tail(Path(run["log"]))
        if tail:
            say(tail)
        if run["done"]:
            with open(state, "a") as f:
                f.write(stage.name + "\n")
            verdict = "done"
        elif run["timed_out"]:
            verdict = (f"TIMED OUT after {tmo:g} s; killed process group {run['pgid']} "
                       f"({len(run['killed'])} processes)")
            outcomes.add(1)
        elif run["rc"] != 0:
            verdict = "FAILED"
            outcomes.add(1)
        else:
            verdict = (f"not done: its last JSON line names platform {run['platform']!r}, "
                       f"the stage needs {stage.platform!r}")
            outcomes.add(2)
        with open(records, "a") as f:
            f.write(json.dumps(run) + "\n")
        say(f"--- stage {stage.name} rc={run['rc']} in {run['seconds']:.1f} s: {verdict} ---")
    status = min(outcomes) if outcomes else 0
    say(f"=== measure: done [{','.join(read_done(state))}], exit {status} ===")
    return status


def run_tail(log_path: Path) -> str:
    lines = log_path.read_text(errors="replace").rstrip().splitlines() if log_path.is_file() else []
    return "\n".join(lines[-TAIL_LINES:])


def _pairs(items: Sequence[str], what: str) -> Dict[str, str]:
    out = {}
    for item in items:
        name, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"{what} takes STAGE=VALUE, got {item!r}")
        out[name] = value
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="", help="comma-separated subset (default: every stage)")
    ap.add_argument("--budget", type=float, default=8 * 3600,
                    help="seconds for the whole session (default 8 h)")
    ap.add_argument("--always", action="store_true", help="rerun stages already done")
    ap.add_argument("--device", default=None,
                    help='passed to every card stage (default: theirs, the card)')
    ap.add_argument("--state-dir", type=Path, default=DEFAULT_STATE_DIR)
    ap.add_argument("--timeout", action="append", default=[], metavar="STAGE=SECONDS",
                    help="a stage's own timeout")
    ap.add_argument("--stage-args", action="append", default=[], metavar="STAGE=ARGS",
                    help="arguments appended to a stage's command (split on spaces)")
    ap.add_argument("--list", action="store_true", help="print the stages and exit")
    args = ap.parse_args(argv)
    if args.list:
        for s in stages(args.state_dir):
            print(f"{s.name:11s} {s.timeout:6.0f} s  {s.platform:4s}  python -m {s.module} "
                  + " ".join(s.args))
        return 0
    try:
        timeouts = {k: float(v) for k, v in _pairs(args.timeout, "--timeout").items()}
    except ValueError:
        raise SystemExit("--timeout takes STAGE=SECONDS")
    extra = {k: v.split() for k, v in _pairs(args.stage_args, "--stage-args").items()}
    names = [n.strip() for n in args.stages.split(",") if n.strip()]
    return session(names, args.budget, args.always, args.device, args.state_dir, timeouts,
                   extra, say=lambda s: print(s, flush=True))


if __name__ == "__main__":
    sys.exit(main())
