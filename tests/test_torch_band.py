"""``scripts/band_torch.py``, the port's band, on the CPU:

(a) ``judge`` on the JAX package's own 16 recorded unicycle seeds
    reproduces ``scripts/r9_analyze.py``'s figures (s12345 525.9 / 46 / 49,
    s111 649.1 / 49) and counts 15 of 16 converged;
(b) the reference's 12 r9 seeds, judged as if they were the port, pass;
    the same set with 3 seeds replaced by s12345's rows fails, and so does
    the set with every reward 20 lower;
(c) ``run --cpu`` (tiny widths) gives the same ``progress.txt`` rows for
    3 episodes in chunks of 1 + 2 as for 3 episodes uncut, and the same
    final checkpoint; ``run.json`` names the host's cores;
(d) a chunk cut after its first episode (SIGTERM to ``run``) keeps no row
    past the checkpoint it resumed from, and continuing gives the uncut
    rows;
(e) a fresh process that imports the script holds no ``jax`` and no
    ``nlbac_tpu*`` module, and ``run`` without a card raises unless given
    ``--cpu``;
(f) ``judge`` on each band committed from the card (``results/
    torch_band/unicycle/``, ``unicycle_xla_squash/``, ``nbc_unicycle/``,
    ``cars/``, ``nbc_pvtol/``)
    gives the verdict, the converged count and the median last-50 reward
    (to 0.01) that ``PERF.md``'s table of the bands run states, and the
    committed ``judge.json``'s;
(g) with band seeds short, ``judge`` fails a band that no outcome of
    theirs can pass, passes one whose short seeds are known misses (their
    rows already break a count limit) at every reward they could end at,
    and otherwise tables what each number of misses among them leads to.
(h) ``run --cpu --cli_args "--squash xla"`` passes the flag to every
    chunk (the second chunk resumes the first's checkpoint under it);
(i) ``judge`` names each miss's mode on the committed bands and the
    reference: a graze (reward and goals met, too many violation
    episodes) or a collapse (reward or goals broken, or a short seed's
    goals limit broken already); nbc_unicycle's reference has none.
(j) a kept checkpoint is packed losslessly (every array back bit for
    bit, a repeated array stored once), ``--carry_mb`` counts it packed,
    and a later ``run`` resumes from it to the uncut rows and checkpoint,
    leaving no unpacked copy behind.
(k) ``Runner.fit`` on a fixed clock, with no process: a fresh seed's
    chunk is sized from the newest chunk another seed of the run kept
    (its own last chunk first), each episode counted at the preset's
    ``max_episode_steps`` and not at the last chunk's mean, no chunk
    starts (its slot idle) where one such episode cannot end before the
    deadline, and with no rate anywhere the chunk stays as asked; each
    kept chunk and ``run.json`` name the host's CPU model.

Tolerances: none; (a) compares at the printed precision (0.05), the rest
bit for bit.
"""

import importlib.util
import json
import lzma
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "band_torch.py"


def _load():
    spec = importlib.util.spec_from_file_location("band_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


band = _load()
PRESET = band.PRESETS["unicycle"]


def ref_files():
    return band.find_seeds([ROOT / d for d in PRESET["ref"]])


def judge(port, tmp_path, *extra):
    out = tmp_path / "judge.json"
    assert band.main(["judge", "--port", str(port), "--json", str(out)]
                     + list(extra)) == 0
    return json.loads(out.read_text())


def as_port(tmp_path, files, rewrite=None):
    """A port directory of ``{seed: progress.txt}``, each file's rows
    optionally passed through ``rewrite(header, lines)``."""
    port = tmp_path / "port"
    for seed, path in files.items():
        (port / f"s{seed}").mkdir(parents=True)
        header, lines, _ = band.read_progress(path)
        if rewrite is not None:
            lines = rewrite(header, lines)
        (port / f"s{seed}" / "progress.txt").write_text(
            "\n".join([header] + lines) + "\n")
    return port


def test_judge_reproduces_reference_figures(tmp_path):
    files = ref_files()
    assert sorted(files) == sorted(PRESET["seeds"] + PRESET["fallback"])
    ref = judge(tmp_path / "empty", tmp_path)["reference"]
    s = ref["s12345"]
    assert round(s["last50_reward"], 1) == 525.9
    assert (s["goals_last50"], s["violation_episodes_last100"]) == (46, 49)
    assert not s["converged"]
    s = ref["s111"]
    assert round(s["last50_reward"], 1) == 649.1
    assert s["goals_last50"] == 49 and s["converged"]
    assert sum(v["converged"] for v in ref.values()) == 15
    others = [v for k, v in ref.items() if k not in ("s12345", "s111")]
    assert min(v["last50_reward"] for v in others) >= 681.15
    assert max(v["last50_reward"] for v in others) <= 693.25
    assert all(v["goals_last50"] == 50 for v in others)
    assert all(v["violation_episodes_last100"] <= 5 for v in others)


@pytest.mark.parametrize("case", ["reference", "three_low_modes",
                                  "rewards_20_lower"])
def test_judge_verdict_on_reference_seeds(tmp_path, case):
    files = {s: p for s, p in ref_files().items() if s in PRESET["seeds"]}
    assert len(files) == 12
    rewrite = None
    if case == "three_low_modes":
        for seed in (100, 101, 102):
            files[seed] = files[12345]
    elif case == "rewards_20_lower":
        def rewrite(header, lines):
            i = header.split("\t").index("reward_train")
            out = []
            for ln in lines:
                cells = ln.split("\t")
                cells[i] = repr(float(cells[i]) - 20.0)
                out.append("\t".join(cells))
            return out
    got = judge(as_port(tmp_path, files, rewrite), tmp_path)
    if case == "reference":
        assert got["verdict"] == "pass"
        assert got["port_converged"] == 11
    elif case == "three_low_modes":
        assert got["port_converged"] == 8
        assert got["verdict"] == "fail"
    else:
        assert got["port_converged"] == 11
        assert got["port_median_last50_reward"] < band.PASS_MEDIAN
        assert got["verdict"] == "fail"
    assert got["mann_whitney_u"]["n_port"] == 12


def test_judge_first_episodes(tmp_path):
    """``--episodes N`` judges every seed's first N episodes, both
    sides, and says that it is not the band."""
    files = {s: p for s, p in ref_files().items() if s in PRESET["seeds"]}
    port = as_port(tmp_path, files, lambda h, lines: lines[:120])
    out = tmp_path / "at100.json"
    assert band.main(["judge", "--port", str(port), "--episodes", "100",
                      "--json", str(out)]) == 0
    got = json.loads(out.read_text())
    _, _, c = band.read_progress(files[12345])
    for side in ("port", "reference"):
        s = got[side]["s12345"]
        assert s["episodes"] == 100 and s["complete"]
        assert s["last50_reward"] == pytest.approx(
            c["reward_train"][50:100].mean(), rel=1e-12)
        assert s["env_steps"] == int(c["episode_steps"][:100].sum())
    assert got["port"] == {k: v for k, v in got["reference"].items()
                           if int(k[1:]) in PRESET["seeds"]}
    # the band needs 200 episodes: 120 are incomplete
    assert judge(port, tmp_path)["verdict"] == "incomplete"


def test_judge_fallback_and_incomplete():
    """The band rules' edges: exactly 3 seeds not converged calls seeds
    108-111, whose 16 seeds then decide; a short seed is incomplete unless
    no outcome of the short seeds can pass (then a fail), and the outcome
    table says what each number of misses among them leads to."""
    ok = {"complete": True, "converged": True, "last50_reward": 690.0}
    low = {"complete": True, "converged": False, "last50_reward": 520.0}
    seeds, fallback = PRESET["seeds"], PRESET["fallback"]
    stats = {s: dict(ok) for s in seeds}
    for s in seeds[:3]:
        stats[s] = dict(low)
    assert band.verdict(stats, seeds, fallback) == "fallback"
    stats.update({s: dict(ok) for s in fallback})
    assert band.verdict(stats, seeds, fallback) == "pass"
    stats[fallback[0]] = dict(low)
    assert band.verdict(stats, seeds, fallback) == "fail"
    stats = {s: dict(ok) for s in seeds}
    stats[seeds[0]] = {**ok, "complete": False, "converged": False}
    assert band.verdict(stats, seeds, fallback) == "incomplete"
    # the committed band's shape: 8 complete, 2 of them missed (at a high
    # reward, as s102 and s106), 4 short
    short = {**ok, "complete": False, "converged": False}
    stats = {s: dict(ok) for s in seeds}
    for s in seeds[4:6]:
        stats[s] = {**ok, "converged": False}
    for s in seeds[-4:]:
        stats[s] = dict(short)
    assert band.verdict(stats, seeds, fallback) == "incomplete"
    table = band.outcomes(stats, seeds, fallback)
    assert [r["verdict"] for r in table] == [
        "pass", "fallback", "fail", "fail", "fail"]
    assert table[1]["fallback_converged_needed"] == 4
    assert table[1]["fallback_short"] == list(fallback)
    # decided while incomplete: 4 complete seeds missed, so no outcome of
    # the short ones passes
    for s in seeds[:2]:
        stats[s] = dict(low)
    assert band.verdict(stats, seeds, fallback) == "fail"
    assert {r["verdict"] for r in band.outcomes(stats, seeds, fallback)} \
        == {"fail"}
    # 3 missed with one short: converging calls the fallback, missing fails
    stats = {s: dict(ok) for s in seeds}
    for s in seeds[:3]:
        stats[s] = dict(low)
    stats[seeds[-1]] = dict(short)
    assert band.verdict(stats, seeds, fallback) == "incomplete"
    assert [r["verdict"] for r in band.outcomes(stats, seeds, fallback)] \
        == ["fallback", "fail"]
    # the fallback decided before its seeds are complete: one of them
    # missed where all 4 must converge
    stats[seeds[-1]] = dict(ok)
    stats[fallback[0]] = dict(low)
    assert band.verdict(stats, seeds, fallback) == "fail"
    stats[fallback[0]] = dict(ok)
    assert band.verdict(stats, seeds, fallback) == "fallback"
    # a median that the short seeds cannot lift: 6 complete seeds far under
    # the floor, converged only by the limit of 640 (the short ones score
    # at most anything, at least 640 if converged)
    stats = {s: {**ok, "last50_reward": 645.0} for s in seeds}
    for s in seeds[:2]:
        stats[s] = dict(short)
    assert band.outcomes(stats, seeds, fallback)[0]["verdict"] == "fail"
    assert band.verdict(stats, seeds, fallback) == "fail"
    for s in seeds[2:8]:
        stats[s] = dict(ok)
    assert [r["verdict"] for r in band.outcomes(stats, seeds, fallback)] \
        == ["pass or fail", "pass or fail", "pass or fail"]
    # a short seed's rows that already break a count limit of its last
    # window: 2 goals missed in episodes 150-159 leave at most 48 of 50
    c = {"Episode": np.arange(160), "safety_cost_train": np.zeros(160),
         "goal_met": np.ones(160)}
    assert not band.cannot_converge(c, 200)
    c["goal_met"][150] = 0
    assert not band.cannot_converge(c, 200)
    c["goal_met"][151] = 0
    assert band.cannot_converge(c, 200)
    c["goal_met"][:] = 1
    c["safety_cost_train"][[99, 100, 120, 130, 140, 150]] = 0.1
    assert not band.cannot_converge(c, 200)
    c["safety_cost_train"][159] = 0.1
    assert band.cannot_converge(c, 200)


def test_judge_outcomes_on_doctored_rows(tmp_path):
    """``judge`` on the reference's 12 band seeds doctored into the
    committed band's shape (s12345's miss kept, s100 made to miss with 6
    violation episodes in its last 100, s103-s105 and s107 cut to 120
    episodes) prints and records the outcome table; a short seed whose
    rows already break the violation limit counts as a miss; with 4
    misses among complete and such seeds, it is a fail before the short
    seeds end."""
    files = {s: p for s, p in ref_files().items() if s in PRESET["seeds"]}

    def violate(header, lines):
        i = header.split("\t").index("safety_cost_train")
        out = []
        for n, ln in enumerate(lines):
            cells = ln.split("\t")
            if n >= 190:
                cells[i] = "0.5"
            out.append("\t".join(cells))
        return out

    port = as_port(tmp_path, files)
    cut = (103, 104, 105, 107)
    for seed in (100,) + cut:
        path = port / f"s{seed}" / "progress.txt"
        header, lines, _ = band.read_progress(path)
        lines = violate(header, lines) if seed == 100 else lines[:120]
        path.write_text("\n".join([header] + lines) + "\n")
    got = judge(port, tmp_path)
    assert got["verdict"] == "incomplete"
    assert got["port"]["s100"]["violation_episodes_last100"] >= 6
    assert got["short_seeds"] == list(cut)
    # the median holds even with the short seeds converged at 640
    assert [r["verdict"] for r in got["outcomes"]] == [
        "pass", "fallback", "fail", "fail", "fail"]
    assert got["outcomes"][1]["fallback_converged_needed"] == 4
    assert not any(got["port"][f"s{s}"]["cannot_converge"] for s in cut)
    # s107's rows made to violate in 6 of its episodes 100-119: it can no
    # longer converge (episodes 100-199 are its last 100), so the table
    # starts at 1 miss
    path = port / "s107" / "progress.txt"
    header, lines, _ = band.read_progress(path)
    i = header.split("\t").index("safety_cost_train")
    lines = ["\t".join(c[:i] + ["0.5"] + c[i + 1:])
             if 100 <= n < 106 else ln
             for n, ln in enumerate(lines) for c in [ln.split("\t")]]
    path.write_text("\n".join([header] + lines) + "\n")
    got = judge(port, tmp_path)
    assert got["port"]["s107"]["cannot_converge"]
    assert got["verdict"] == "incomplete"
    assert [(r["misses"], r["verdict"]) for r in got["outcomes"]] == [
        (1, "fallback"), (2, "fail"), (3, "fail"), (4, "fail")]
    # one more complete seed missed: 3 known and s107, a fail already
    path = port / "s101" / "progress.txt"
    header, lines, _ = band.read_progress(path)
    path.write_text("\n".join([header] + violate(header, lines)) + "\n")
    got = judge(port, tmp_path)
    assert got["verdict"] == "fail" and got["outcomes"] == []
    # and without s107's early miss, 2 more complete misses fail it too
    for seed in (102,):
        path = port / f"s{seed}" / "progress.txt"
        header, lines, _ = band.read_progress(path)
        path.write_text("\n".join([header] + violate(header, lines)) + "\n")
    shutil.copy(files[107], port / "s107" / "progress.txt")
    header, lines, _ = band.read_progress(port / "s107" / "progress.txt")
    (port / "s107" / "progress.txt").write_text(
        "\n".join([header] + lines[:120]) + "\n")
    got = judge(port, tmp_path)
    assert not got["port"]["s107"]["cannot_converge"]
    assert got["verdict"] == "fail" and got["outcomes"] == []


def test_judge_outcomes_on_doctored_rows_early_miss(tmp_path):
    """A short seed goal-less in episodes 150-151 is a known miss (a
    collapse: at most 48 goals in its last 50): beside 2 complete misses
    (s12345's collapse, s100 made to graze) it calls the fallback seeds,
    and with all 4 of them converged the band passes before the short
    seed ends, whatever last-50 reward it would end at; one fallback seed
    missed fails it. Before its second goal-less episode it is open."""
    files = {s: p for s, p in ref_files().items()
             if s in PRESET["seeds"] + PRESET["fallback"]}
    port = as_port(tmp_path, files)

    def doctor(seed, rewrite):
        path = port / f"s{seed}" / "progress.txt"
        header, lines, _ = band.read_progress(path)
        path.write_text("\n".join([header] + rewrite(header, lines)) + "\n")

    def set_cell(column, value, rows):
        def rewrite(header, lines):
            i = header.split("\t").index(column)
            return ["\t".join(c[:i] + [value] + c[i + 1:]) if n in rows
                    else ln for n, ln in enumerate(lines)
                    for c in [ln.split("\t")]]
        return rewrite

    doctor(100, set_cell("safety_cost_train", "0.5", range(190, 200)))
    doctor(105, lambda h, lines: set_cell("goal_met", "0", {150})(
        h, lines[:151]))
    got = judge(port, tmp_path)
    assert got["short_seeds"] == [105]
    assert not got["port"]["s105"]["cannot_converge"]
    assert got["port"]["s105"]["miss_mode"] is None
    assert got["verdict"] == "incomplete"
    assert [r["verdict"] for r in got["outcomes"]] == ["pass", "fallback"]
    # a second goal-less episode in the last 50: a miss, so the fallback's
    # 13 of 16 decide (the median of the 16 is over 684 with s105 at
    # either end)
    shutil.copy(files[105], port / "s105" / "progress.txt")
    doctor(105, lambda h, lines: set_cell("goal_met", "0", {150, 151})(
        h, lines[:152]))
    got = judge(port, tmp_path)
    assert got["port"]["s105"]["cannot_converge"]
    assert got["port"]["s105"]["miss_mode"] == "collapse"
    assert got["miss_modes"] == {"s12345": "collapse", "s100": "graze",
                                 "s105": "collapse"}
    assert got["verdict"] == "pass" and got["outcomes"] == []
    assert (got["port_converged"], got["port_complete"]) == (13, 15)
    # one fallback seed missed: 12 of 16
    doctor(108, set_cell("safety_cost_train", "0.5", range(190, 200)))
    got = judge(port, tmp_path)
    assert got["verdict"] == "fail" and got["outcomes"] == []
    # on the rules' own terms: a fallback seed still open keeps the
    # verdict at the fallback; a known miss whose reward decides the
    # median keeps it open
    ok = {"complete": True, "converged": True, "last50_reward": 690.0}
    low = {"complete": True, "converged": False, "last50_reward": 520.0}
    doomed = {"complete": False, "converged": False, "cannot_converge": True,
              "last50_reward": -500.0}
    seeds, fallback = PRESET["seeds"], PRESET["fallback"]
    stats = {s: dict(ok) for s in seeds + fallback}
    stats.update({seeds[0]: dict(low), seeds[1]: dict(low),
                  seeds[2]: dict(doomed)})
    assert band.verdict(stats, seeds, fallback) == "pass"
    del stats[fallback[0]]
    assert band.verdict(stats, seeds, fallback) == "fallback"
    stats = {s: {**ok, "last50_reward": 700.0} for s in seeds}
    for s in seeds[:5]:
        stats[s] = {**ok, "last50_reward": 645.0}
    stats[seeds[-1]] = dict(doomed)
    assert band.verdict(stats, seeds, fallback) == "incomplete"


def run(tmp_path, name, *args, check=True):
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "run", "--cpu", "--seeds", "7",
         "--out", str(tmp_path / name / "out"),
         "--work", str(tmp_path / name / "work")] + list(args),
        capture_output=True, text=True, timeout=300)
    if check:
        assert out.returncode == 0, out.stdout + out.stderr
    return out


def kept(tmp_path, name):
    seed = tmp_path / name / "work" / "s7"
    state = json.loads((seed / "state.json").read_text())
    progress = (tmp_path / name / "out" / "s7" / "progress.txt")
    return state, progress.read_text(), seed / state["checkpoint"]


def same_checkpoint(a, b):
    za, zb = band.unpack_arrays(a), band.unpack_arrays(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.fixture(scope="module")
def uncut(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uncut")
    run(tmp, "uncut", "--episodes", "3", "--chunk", "3")
    return kept(tmp, "uncut") + (tmp / "uncut" / "out" / "s7",)


def test_run_chunked_equals_uncut(tmp_path, uncut):
    run(tmp_path, "chunked", "--episodes", "1", "--chunk", "1")
    state, rows, _ = kept(tmp_path, "chunked")
    assert len(state["rows"]) == 1
    run(tmp_path, "chunked", "--episodes", "3", "--chunk", "2")
    state, rows, ckpt = kept(tmp_path, "chunked")
    assert [c["episodes"] for c in state["chunks"]] == [[0, 0], [1, 2]]
    assert rows == uncut[1]
    assert len(rows.splitlines()) == 4
    same_checkpoint(ckpt, uncut[2])
    info = json.loads((tmp_path / "chunked" / "out" / "s7" /
                       "run.json").read_text())
    assert info["episodes"] == 3 and info["cards"] == ["cpu"]
    assert info["host_cores"] == [len(os.sched_getaffinity(0))]
    assert info["env_steps"] == uncut[0]["env_steps"]


# fit's fixed clock, and a chunk's start-up seconds (its process's seconds
# beyond its episodes')
NOW, STARTUP = 5000.0, 25.0
FIT_PRESET = "nbc_pvtol"
# seconds of one FIT_PRESET episode of max_episode_steps at 0.1 s an env
# step, a quarter to spare
LONG_EPISODE = 1.25 * 0.1 * band.PRESETS[FIT_PRESET]["max_episode_steps"]


def chunk_record(first, last, env_steps, train_seconds):
    return {"episodes": [first, last], "env_steps": env_steps,
            "train_seconds": train_seconds,
            "seconds": train_seconds + STARTUP}


def fit_runner(tmp_path, left, seeds=(), *flags):
    """A Runner of FIT_PRESET with ``--chunk 5`` whose clock stands at NOW
    and whose deadline is ``left`` seconds later (None: no time limit)."""
    argv = ["run", "--preset", FIT_PRESET, "--chunk", "5",
            "--out", str(tmp_path / "out"), "--work", str(tmp_path / "work")]
    if left is not None:
        argv += ["--time_limit", str(left)]
    args = band.build_parser().parse_args(argv + list(flags))
    args.episodes = band.PRESETS[FIT_PRESET]["episodes"]
    return band.Runner(args, list(seeds), [0], {0: "card"}, 0,
                       clock=lambda: NOW)


def fit_seed(tmp_path, seed, chunks=()):
    s = band.Seed(seed, str(tmp_path / "work"), str(tmp_path / "out"),
                  band.PRESETS[FIT_PRESET]["episodes"])
    s.state["chunks"] = list(chunks)
    s.state["rows"] = ["row"] * sum(c["episodes"][1] - c["episodes"][0] + 1
                                    for c in chunks)
    return s


def test_fit_sizes_a_fresh_seed_from_the_call(tmp_path):
    """A seed with no kept chunk takes its rate from the newest chunk that
    another seed of the run kept: 0.1 s an env step and 25 s of start-up
    leave room for 3 whole episodes of max_episode_steps, not the 5 asked;
    the seed's own last chunk, where it has one, comes first."""
    runner = fit_runner(tmp_path, STARTUP + 3.5 * LONG_EPISODE)
    runner.kept = [chunk_record(0, 4, 1000, 500.0),  # 0.5 s an env step
                   chunk_record(0, 4, 9000, 900.0)]  # 0.1, the newest
    fresh = fit_seed(tmp_path, 1)
    assert runner.rate(fresh) == (0.1, STARTUP)
    assert runner.fit(fresh, 0, 5) == 3
    # its own chunk (0.2 s an env step) over the call's newest
    own = fit_seed(tmp_path, 2, [chunk_record(0, 4, 9000, 1800.0)])
    assert runner.rate(own) == (0.2, STARTUP)
    assert runner.fit(own, 5, 10) == 5 + 1


def test_fit_bounds_each_episode_by_max_episode_steps(tmp_path):
    """The seed's last chunk held 5 short episodes (200 env steps each, 20
    s at 0.1 s an env step): at that mean all 5 asked would fit, but each
    episode is counted at max_episode_steps, so only 2 are started."""
    left = STARTUP + 2.5 * LONG_EPISODE
    seed = fit_seed(tmp_path, 1, [chunk_record(0, 4, 1000, 100.0)])
    runner = fit_runner(tmp_path, left, [seed])
    mean_episode = 1.25 * 100.0 / 5
    assert int((left - STARTUP) / mean_episode) >= 5
    assert runner.episode_steps() == 2000
    assert runner.fit(seed, 5, 10) == 5 + 2
    # a cut of the episodes' length reaches the bound
    cut = fit_runner(tmp_path, left, [seed], "--cli_args",
                     "--max_episode_steps 500")
    assert cut.episode_steps() == 500
    assert cut.fit(seed, 5, 10) == 10
    assert fit_runner(tmp_path, left, [seed], "--cpu").episode_steps() == 40


def test_fit_starts_no_chunk_that_cannot_hold_an_episode(tmp_path,
                                                          monkeypatch):
    """Less than one max_episode_steps episode (and the start-up) before
    the deadline: ``fit`` gives no episode, ``chunk`` starts no process and
    records the seed as idle, and the slot stays idle (its seed short)."""
    seed = fit_seed(tmp_path, 1, [chunk_record(0, 4, 9000, 900.0)])
    other = fit_seed(tmp_path, 2)
    runner = fit_runner(tmp_path, STARTUP + 0.9 * LONG_EPISODE,
                        [seed, other])
    assert runner.fit(seed, 5, 10) == 5

    def no_process(*args, **kwargs):
        raise AssertionError("a chunk process was started")

    monkeypatch.setattr(band.subprocess, "Popen", no_process)
    runner.slot_loop(0)
    assert runner.idle == [(1, 5)]
    # the slot left the queue's next seed alone and kept nothing
    assert runner.queue == [other] and runner.kept == []
    assert (runner.failed, runner.cut) == ([], [])
    assert seed.done == 5 and not os.path.exists(
        os.path.join(seed.work, "chunk_ep5-4.log"))


def test_fit_without_a_rate_keeps_the_chunk_asked(tmp_path):
    """No chunk kept by the seed or by any seed of the run (the band's very
    first chunk), or no time limit: the chunk stays as asked, however close
    the deadline."""
    fresh = fit_seed(tmp_path, 1)
    runner = fit_runner(tmp_path, 10.0, [fresh])
    assert runner.rate(fresh) is None
    assert runner.fit(fresh, 0, 5) == 5
    seed = fit_seed(tmp_path, 2, [chunk_record(0, 4, 9000, 900.0)])
    assert fit_runner(tmp_path, None, [seed]).fit(seed, 5, 10) == 10


def test_chunk_records_name_the_cpu_model(uncut):
    """Each kept chunk and ``run.json`` name the host's CPU model beside its
    cores, as ``/proc/cpuinfo`` gives it."""
    model = band.cpu_model()
    assert model
    assert [c["cpu_model"] for c in uncut[0]["chunks"]] == [model]
    info = json.loads((uncut[3] / "run.json").read_text())
    assert info["cpu_models"] == [model]


def test_run_packed_carry_equals_uncut(tmp_path, uncut):
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
              "b": np.float32(2.5), "c": np.zeros((0, 5), np.float32),
              "d": np.array([1, -2, 3], np.int64),
              "e": np.frombuffer(b"xyz", np.uint8)}
    arrays["f"] = arrays["a"].copy()
    np.savez(tmp_path / "ck.npz", **arrays)
    packed = str(tmp_path / "ck.xz")
    band.pack_checkpoint(str(tmp_path / "ck.npz"), packed)
    back = band.unpack_arrays(packed)
    assert list(back) == list(arrays)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        assert back[k].tobytes() == a.tobytes(), k
    assert b'"same_as": "a"' in lzma.open(packed).read()

    import argparse

    run(tmp_path, "packed", "--episodes", "1", "--chunk", "1")
    work, out = (str(tmp_path / "packed" / d) for d in ("work", "out"))
    band.carry([band.Seed(7, work, out, 3)], argparse.Namespace(
        episodes=3, carry_mb=63))
    state, _, ckpt = kept(tmp_path, "packed")
    assert state["checkpoint"] == "checkpoint_ep1.xz" and ckpt.exists()
    run(tmp_path, "packed", "--episodes", "3", "--chunk", "2")
    state, rows, ckpt = kept(tmp_path, "packed")
    assert [c["episodes"] for c in state["chunks"]] == [[0, 0], [1, 2]]
    assert rows == uncut[1]
    same_checkpoint(ckpt, uncut[2])
    assert sorted(os.listdir(work + "/s7")) == [
        "checkpoint_ep3.xz", "chunk_ep0-0.log", "chunk_ep1-2.log",
        "state.json"]


def test_run_cut_chunk_then_continued(tmp_path, uncut):
    run(tmp_path, "cut", "--episodes", "1", "--chunk", "1")
    chunk = tmp_path / "cut" / "work" / "s7" / "chunk"
    proc = subprocess.Popen(
        [sys.executable, str(SCRIPT), "run", "--cpu", "--seeds", "7",
         "--episodes", "3", "--chunk", "2",
         "--out", str(tmp_path / "cut" / "out"),
         "--work", str(tmp_path / "cut" / "work")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    # the chunk of episodes 1-2 has written episode 1's row
    while time.monotonic() - t0 < 240 and proc.poll() is None:
        rows = [len(p.read_text().splitlines())
                for p in chunk.glob("*-run*/*/*_s7/progress.txt")]
        if rows and max(rows) >= 2:
            break
        time.sleep(0.005)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 3, out
    state, rows, _ = kept(tmp_path, "cut")
    # nothing past episode 0's checkpoint is kept
    assert len(state["rows"]) == 1 and len(rows.splitlines()) == 2
    assert not chunk.exists()
    assert rows.splitlines() == uncut[1].splitlines()[:2]
    run(tmp_path, "cut", "--episodes", "3", "--chunk", "2")
    state, rows, ckpt = kept(tmp_path, "cut")
    assert rows == uncut[1]
    same_checkpoint(ckpt, uncut[2])
    calls = json.loads((tmp_path / "cut" / "work" / "calls.json").read_text())
    assert [len(c["cut"]) for c in calls] == [0, 1, 0]


def test_seed_without_work_state(tmp_path, uncut):
    """A seed whose work directory is gone (it is not committed) is done
    when its kept files hold every episode, and otherwise starts from
    episode 0, its partial files removed."""
    out = tmp_path / "out"
    shutil.copytree(uncut[3], out / "s7")
    got = run(tmp_path, "", "--episodes", "3", "--out", str(out),
              "--work", str(tmp_path / "work"))
    assert "0 of 1 seeds to train" in got.stdout
    assert (out / "s7" / "progress.txt").read_text() == uncut[1]
    assert json.loads((out / "s7" / "run.json").read_text())["episodes"] == 3
    seed = band.Seed(7, str(tmp_path / "work4"), str(out), 4)
    assert seed.done == 0 and not (out / "s7").exists()


def test_carry_keeps_what_fits(tmp_path):
    """``--carry_mb``: finished seeds drop their checkpoints; unfinished
    ones keep theirs, the furthest first, while they fit; the rest start
    afresh, their kept rows removed."""
    import argparse

    work, out = str(tmp_path / "work"), str(tmp_path / "out")
    seeds = []
    for seed, done, steps, mib in ((1, 5, 500, 2.0), (2, 3, 300, 2.0),
                                   (3, 5, 900, 0.5), (4, 8, 1000, 3.0)):
        s = band.Seed(seed, work, out, 8)
        s.state.update(header="Episode", rows=[str(i) for i in range(done)],
                       env_steps=steps, checkpoint=f"checkpoint_ep{done}.npz")
        Path(s.checkpoint()).write_bytes(b"\0" * int(mib * 2 ** 20))
        s.save_state()
        s.write_out()
        seeds.append(s)
    band.carry(seeds, argparse.Namespace(episodes=8, carry_mb=3))
    again = {s: band.Seed(s, work, out, 8) for s in (1, 2, 3, 4)}
    assert [again[s].done for s in (1, 2, 3, 4)] == [5, 0, 5, 8]
    assert again[4].checkpoint() is None
    assert all(Path(again[s].checkpoint()).exists() for s in (1, 3))
    assert not (tmp_path / "out" / "s2").exists()
    assert (tmp_path / "out" / "s4" / "progress.txt").exists()


def test_script_imports_no_jax():
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('b', {str(SCRIPT)!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib', 'nlbac_tpu'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_run_without_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "run", "--seeds", "7",
         "--out", str(tmp_path / "out"), "--work", str(tmp_path / "work")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "work").exists()


# a row of PERF.md's table of the bands run: the band's directory, its
# verdict, converged of complete seeds and median last-50 reward
BAND_ROW = re.compile(r"^\| `results/torch_band/(\w+)/` \|.*\| \*\*(\w+)\*\* "
                      r"\| (\d+) of (\d+) \| ([0-9.]+|none) \|$", re.M)


# the bands whose verdict is final: no later run changes it
DECIDED = {"unicycle": "fail", "unicycle_xla_squash": "pass",
           "nbc_unicycle": "pass", "cars": "pass"}


@pytest.mark.parametrize("band_dir", ["unicycle", "unicycle_xla_squash",
                                      "nbc_unicycle", "cars", "nbc_pvtol"])
def test_committed_band_verdict_matches_perf(tmp_path, band_dir):
    port = ROOT / "results" / "torch_band" / band_dir
    stated = {m[0]: m[1:] for m in BAND_ROW.findall(
        (ROOT / "PERF.md").read_text())}
    assert band_dir in stated, f"PERF.md states no verdict of {band_dir}"
    verdict, converged, complete, median = stated[band_dir]
    committed = json.loads((port / "judge.json").read_text())
    got = judge(port, tmp_path, "--preset", committed["preset"])
    assert got["verdict"] == verdict == committed["verdict"]
    assert verdict == DECIDED.get(band_dir, "incomplete")
    assert (got["port_converged"], got["port_complete"]) == (
        int(converged), int(complete))
    got_median = got["port_median_last50_reward"]
    # a band with no complete seed yet has no median
    assert median == ("none" if got_median is None else f"{got_median:.2f}")
    assert committed["port"] == got["port"]


def test_run_passes_cli_args_to_every_chunk(tmp_path):
    """``--cli_args "--squash xla"`` reaches both chunks' processes: each
    chunk record keeps it, and the second chunk resumed the first's
    checkpoint, which records the squash (a resume under another squash
    is refused, and the chunk would fail)."""
    run(tmp_path, "xla", "--episodes", "2", "--chunk", "1", "--cli_args",
        "--squash xla")
    state, rows, ckpt = kept(tmp_path, "xla")
    assert [c["episodes"] for c in state["chunks"]] == [[0, 0], [1, 1]]
    assert [c["cli_args"] for c in state["chunks"]] == ["--squash xla"] * 2
    extra = band.unpack_arrays(ckpt)["extra"]
    assert json.loads(bytes(extra).decode())["squash"] == "xla"
    assert len(rows.splitlines()) == 3


@pytest.mark.parametrize("band_dir, modes, ref_modes", [
    pytest.param("unicycle", {"s102": "graze", "s106": "graze",
                              "s107": "graze", "s104": "collapse"},
                 {"s12345": "collapse"}, id="unicycle-modes0"),
    pytest.param("unicycle_xla_squash", {"s107": "collapse"},
                 {"s12345": "collapse"}, id="unicycle_xla_squash-modes1"),
    pytest.param("nbc_unicycle", {"s100": "collapse", "s106": "collapse",
                                  "s105": "collapse"},
                 {}, id="nbc_unicycle-modes2"),
])
def test_judge_names_each_miss_mode(tmp_path, band_dir, modes, ref_modes):
    """(j): the ``torch.tanh`` band's three grazes and one collapse, the
    reference's s12345 a collapse, the ``--squash xla`` band's s107 a
    collapse, and nbc_unicycle's s100 and s106 collapses and s105, short
    at 152 episodes with no goal in 150-151 (its reference has no miss); in each seed's figures and in ``miss_modes``, for seeds
    that are complete and not converged and for short seeds whose goals
    limit is broken already (a collapse)."""
    port = ROOT / "results" / "torch_band" / band_dir
    preset = json.loads((port / "judge.json").read_text())["preset"]
    got = judge(port, tmp_path, "--preset", preset)
    assert {s: m for s, m in got["miss_modes"].items() if s in modes} == \
        modes
    assert got["ref_miss_modes"] == ref_modes
    for name, st in got["port"].items():
        assert st["miss_mode"] == got["miss_modes"].get(name)
        if st["complete"]:
            assert (st["miss_mode"] is None) == st["converged"]
        else:
            # a short seed has a mode only once it is a known collapse
            assert st["miss_mode"] in (None, "collapse")
            assert st["miss_mode"] is None or st["cannot_converge"]
