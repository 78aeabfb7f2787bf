"""``scripts/band_torch.py``'s rules for cars, pvtol, nbc_unicycle and
nbc_pvtol, and its reading of a rerun against the earlier run's rows, on
the CPU:

(a) each preset's converged rule admits exactly the reference seeds that
    ``PARITY.md`` counts as converged or functional (cars 16/16, pvtol all
    but s105, nbc_unicycle 16/16, nbc_pvtol all but s104);
(b) the reference's 12 band seeds, judged as if they were the port, pass;
    the same seeds with every reward lowered by the smallest drop the
    script's docstring states for the preset fail, and lowered by one
    ``DROP_STEP`` less pass; one seed short of the budget is
    ``incomplete``; exactly 3 seeds not converged call the fallback seeds,
    which then decide;
(c) 12 seeds (and 4 for the fallback) drawn with replacement from the
    reference's 16 miss the pass at most 5% of the time, at the rate the
    script's docstring states (``DRAWS`` draws, seed 0);
(d) ``run`` hands each preset's CLI process the preset's defaults (only
    the seed, the chunk's last episode and the output change), and
    ``run --cpu --preset cars`` and ``--preset nbc_pvtol`` keep a chunk;
(e) a seed restarted from episode 0 over a committed partial
    ``progress.txt`` reads its new rows against the old ones: the first
    differing episode (None when they agree) lands in its ``run.json``,
    and ``--carry_mb`` keeps the old rows of a seed it starts afresh and
    counts every file under ``--carry_dir``;
(f) ``judge``'s figures beside the rules: violation episodes by window,
    the safety cost over the last 100 and the multipliers' means.

Tolerances: none; the bootstrap rates are compared at the docstring's
printed precision (0.001%, exact for 20000 draws), the drops at 0.01.
"""

import argparse
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "band_torch.py"


def _load():
    spec = importlib.util.spec_from_file_location("band_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


band = _load()
PRESETS = ("cars", "pvtol", "nbc_unicycle", "nbc_pvtol")
# PARITY.md's seeds that are neither converged nor functional
NOT_CONVERGED = {"cars": set(), "pvtol": {105}, "nbc_unicycle": set(),
                 "nbc_pvtol": {104}}
DOC = " ".join(band.__doc__.split())


def ref_files(name):
    return band.find_seeds([ROOT / d for d in band.PRESETS[name]["ref"]])


def as_port(tmp_path, files, rewrite=None):
    port = tmp_path / "port"
    for seed, path in files.items():
        (port / f"s{seed}").mkdir(parents=True)
        header, lines, _ = band.read_progress(path)
        if rewrite is not None:
            lines = rewrite(header, lines)
        (port / f"s{seed}" / "progress.txt").write_text(
            "\n".join([header] + lines) + "\n")
    return port


def judge(name, port, tmp_path):
    out = tmp_path / "judge.json"
    assert band.main(["judge", "--preset", name, "--port", str(port),
                      "--json", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", PRESETS)
def test_converged_rule_admits_parity_seeds(name):
    preset = band.PRESETS[name]
    files = ref_files(name)
    assert sorted(files) == sorted(preset["seeds"] + preset["fallback"])
    stats = band.reference_stats(name)
    assert all(st["episodes"] == preset["episodes"] for st in stats.values())
    assert {s for s, st in stats.items() if not st["converged"]} == \
        NOT_CONVERGED[name]


@pytest.mark.parametrize("name", ("unicycle",) + PRESETS)
def test_stated_drop_is_the_smallest(name):
    drop = band.smallest_failing_drop(name)
    assert f"{name} {drop:.2f}" in DOC
    assert drop > band.DROP_STEP


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("case", ["reference", "lowered", "under", "short"])
def test_reference_band_seeds_as_port(tmp_path, name, case):
    preset = band.PRESETS[name]
    files = {s: p for s, p in ref_files(name).items()
             if s in preset["seeds"]}
    assert len(files) == 12
    rewrite, short = None, None
    if case in ("lowered", "under"):
        drop = band.smallest_failing_drop(name) - (
            band.DROP_STEP if case == "under" else 0.0)

        def rewrite(header, lines):
            i = header.split("\t").index("reward_train")
            out = []
            for ln in lines:
                cells = ln.split("\t")
                cells[i] = repr(float(cells[i]) - drop)
                out.append("\t".join(cells))
            return out
    got = judge(name, as_port(tmp_path, files, rewrite), tmp_path)
    median = got["port_median_last50_reward"]
    assert got["preset"] == name
    assert got["rules"] == band.rules_record(preset)
    assert got["port_complete"] == 12
    assert got["mann_whitney_u"]["n_port"] == 12
    if case in ("reference", "under"):
        assert got["verdict"] == "pass"
        assert median >= preset["rules"]["pass_median"]
    if case == "reference":
        assert got["port_converged"] == 12 - len(
            NOT_CONVERGED[name] & set(preset["seeds"]))
    elif case == "lowered":
        assert median < preset["rules"]["pass_median"]
        assert got["verdict"] == "fail"
    if case == "short":
        short = preset["seeds"][0]
        path = tmp_path / "port" / f"s{short}" / "progress.txt"
        lines = path.read_text().splitlines()
        path.write_text("\n".join(lines[:-1]) + "\n")
        got = judge(name, tmp_path / "port", tmp_path)
        assert got["verdict"] == "incomplete"
        assert not got["port"][f"s{short}"]["complete"]


@pytest.mark.parametrize("name", PRESETS)
def test_fallback_verdicts(name):
    """Exactly 3 band seeds not converged call seeds 108-111 (the
    verdict waits for them), whose 16 then decide."""
    preset = band.PRESETS[name]
    rules, seeds, fallback = (preset["rules"], preset["seeds"],
                              preset["fallback"])
    ref = band.reference_stats(name)
    ok = ref[12346]
    assert ok["converged"]
    low = {**ok, "converged": False}
    stats = {s: dict(ok) for s in seeds}
    for s in seeds[:3]:
        stats[s] = dict(low)
    assert band.verdict(stats, seeds, fallback, rules) == "fallback"
    stats.update({s: dict(ok) for s in fallback})
    assert band.verdict(stats, seeds, fallback, rules) == "pass"
    stats[fallback[0]] = dict(low)
    assert band.verdict(stats, seeds, fallback, rules) == "fail"
    # 2 missed: no fallback, a pass; 4 missed: a fail
    stats = {s: dict(ok) for s in seeds}
    for s in seeds[:2]:
        stats[s] = dict(low)
    assert band.verdict(stats, seeds, fallback, rules) == "pass"
    for s in seeds[:4]:
        stats[s] = dict(low)
    assert band.verdict(stats, seeds, fallback, rules) == "fail"


@pytest.mark.parametrize("name", ("unicycle",) + PRESETS)
def test_bootstrap_miss_rate(name):
    miss = band.bootstrap_miss(name)
    assert miss <= 0.05
    assert f"{name} {100 * miss:.3f}%" in DOC
    assert f"{band.DRAWS} draws, seed {band.DRAW_SEED}" in DOC


@pytest.mark.parametrize("name", ("unicycle",) + PRESETS)
def test_run_passes_the_preset_defaults(tmp_path, name):
    sys.path.insert(0, str(ROOT))
    from nlbac_tpu_torch.config import get_config
    from nlbac_tpu_torch.train import cli

    args = band.build_parser().parse_args(
        ["run", "--preset", name, "--out", str(tmp_path / "o"),
         "--work", str(tmp_path / "w")])
    args.episodes = band.PRESETS[name]["episodes"]
    seed = band.Seed(12346, str(tmp_path / "w"), str(tmp_path / "o"),
                     args.episodes)
    runner = band.Runner(args, [seed], [0], {0: "card"}, 0)
    cmd = runner.command(seed, 30)
    assert cmd[1:3] == ["-m", "nlbac_tpu_torch.train.cli"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(cmd[3:]))
    want = get_config(name)
    assert cfg.run.seed == 12346 and cfg.run.max_episodes == 30
    assert dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, seed=want.run.seed,
                                     max_episodes=want.run.max_episodes,
                                     output=want.run.output)) == want
    assert want.run.max_episodes == band.PRESETS[name]["episodes"]
    # the longest episode that ``Runner.fit`` counts a chunk's episodes at
    assert runner.episode_steps() == want.env.max_episode_steps


def run(tmp_path, name, *args, seeds=("7",)):
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "run", "--cpu", "--seeds", *seeds,
         "--out", str(tmp_path / name / "out"),
         "--work", str(tmp_path / name / "work")] + list(args),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out


@pytest.mark.parametrize("name", ("cars", "nbc_pvtol"))
def test_run_cpu_keeps_a_chunk(tmp_path, name):
    got = run(tmp_path, name, "--preset", name, "--episodes", "1",
              "--chunk", "1")
    assert "s7: episodes 0..0 kept" in got.stdout
    header, rows, cols = band.read_progress(
        tmp_path / name / "out" / "s7" / "progress.txt")
    assert len(rows) == 1 and cols["Episode"].tolist() == [0.0]
    if name == "nbc_pvtol":
        assert "barrier_td_loss" in header.split("\t")
    info = json.loads((tmp_path / name / "out" / "s7" /
                       "run.json").read_text())
    assert info["episodes"] == 1 and info["rerun"] is None


def test_rerun_read_against_earlier_rows(tmp_path):
    """Partial files under ``--out``, seed 7's episode 0 as the run gives
    it and seed 8's episodes 0-1 with episode 1's reward doctored: the
    rerun (in chunks of 2, the second past the earlier rows) replaces
    each and records where it first differs from it."""
    two = ("--episodes", "3", "--chunk", "3", "--per_card", "2")
    run(tmp_path, "uncut", *two, seeds=("7", "8"))
    for seed in (7, 8):
        uncut = (tmp_path / "uncut" / "out" / f"s{seed}" /
                 "progress.txt").read_text()
        lines = uncut.splitlines()[:seed - 5]
        if seed == 8:
            cells = lines[2].split("\t")
            i = lines[0].split("\t").index("reward_train")
            cells[i] = "%.6g" % (float(cells[i]) + 1.0)
            lines[2] = "\t".join(cells)
        out = tmp_path / "rerun" / "out" / f"s{seed}"
        out.mkdir(parents=True)
        (out / "progress.txt").write_text("\n".join(lines) + "\n")
        (out / "run.json").write_text("{}\n")
    run(tmp_path, "rerun", "--episodes", "3", "--chunk", "2", "--per_card",
        "2", seeds=("7", "8"))
    for seed, first in ((7, None), (8, 1)):
        out = tmp_path / "rerun" / "out" / f"s{seed}"
        info = json.loads((out / "run.json").read_text())
        assert info["rerun"] == {"earlier_episodes": seed - 6,
                                 "compared_episodes": seed - 6,
                                 "first_differing_episode": first}
        assert (out / "progress.txt").read_text() == (
            tmp_path / "uncut" / "out" / f"s{seed}" /
            "progress.txt").read_text()


def test_carry_keeps_the_earlier_rows(tmp_path):
    """``--carry_mb`` keeps the seeds with the fewest episodes left (the
    env steps they spent do not count), and a rerun it starts afresh
    keeps the earlier rows to read its next rerun against, and its
    reading so far."""
    work, out = str(tmp_path / "work"), str(tmp_path / "out")
    s = band.Seed(5, work, out, 8)
    s.state.update(header="Episode", rows=["0", "1"], env_steps=20,
                   checkpoint="checkpoint_ep2.npz",
                   earlier={"header": "Episode", "rows": ["0", "1", "2"]},
                   rerun={"earlier_episodes": 3, "compared_episodes": 2,
                          "first_differing_episode": 1})
    Path(s.checkpoint()).write_bytes(b"\0" * 2 ** 20)
    s.save_state()
    s.write_out()
    far = band.Seed(6, work, out, 8)
    far.state.update(header="Episode", rows=[str(i) for i in range(6)],
                     env_steps=10, checkpoint="checkpoint_ep6.npz")
    Path(far.checkpoint()).write_bytes(b"\0" * 2 ** 20)
    far.save_state()
    band.carry([s, far], argparse.Namespace(episodes=8, carry_mb=1.5))
    assert band.Seed(6, work, out, 8).done == 6
    again = band.Seed(5, work, out, 8)
    assert again.done == 0 and again.checkpoint() is None
    assert again.state["earlier"]["rows"] == ["0", "1", "2"]
    assert again.state["rerun"] == {"earlier_episodes": 3,
                                    "compared_episodes": 2,
                                    "first_differing_episode": 1}


def test_carry_counts_the_rest_of_carry_dir(tmp_path):
    """What else ``--carry_dir`` holds comes off ``--carry_mb`` first: a
    1 MiB checkpoint fits 1.5 MiB alone, not beside 1 MiB of results."""
    work, out = tmp_path / "hand" / "work", tmp_path / "hand" / "out"
    for extra, kept in ((0, 3), (2 ** 20, 0)):
        s = band.Seed(5, str(work), str(out), 8)
        s.state.update(header="Episode", rows=["0", "1", "2"],
                       env_steps=30, checkpoint="checkpoint_ep3.npz")
        Path(s.checkpoint()).write_bytes(b"\0" * 2 ** 20)
        s.save_state()
        s.write_out()
        (out / "s5" / "other.bin").write_bytes(b"\0" * extra)
        band.carry([s], argparse.Namespace(
            episodes=8, carry_mb=1.5, carry_dir=str(tmp_path / "hand")))
        assert band.Seed(5, str(work), str(out), 8).done == kept
        shutil.rmtree(tmp_path / "hand")


def test_judge_figures_beside_the_rules(tmp_path):
    """Violation episodes by 50-episode window add up to the run's and
    end in the last-100 count; the multipliers' means are None where the
    file has no such column (the r9 runs) and read where it has (r10);
    the backup steps by window likewise (none of the reference's files,
    the port's)."""
    files = ref_files("unicycle")
    for seed in (12345, 108):
        st = band.seed_stats(files[seed], 200)
        _, _, c = band.read_progress(files[seed])
        windows = st["violation_episodes_by_window"]
        assert len(windows) == 4
        assert sum(windows) == int((c["safety_cost_train"] > 0).sum())
        assert sum(windows[2:]) == st["violation_episodes_last100"]
        assert st["safety_cost_last100"] == pytest.approx(
            c["safety_cost_train"][100:].sum(), rel=1e-12)
        mult = st["multipliers_last100"]
        if seed == 12345:
            assert mult == {"rho": None, "lam_max": None}
        else:
            assert mult == {k: pytest.approx(c[k][100:].mean(), rel=1e-12)
                            for k in band.MULTIPLIERS}
        assert st["backup_steps_by_window"] is None
    # the port's files have the backup controller's steps an episode
    port = ROOT / "results" / "torch_band" / "unicycle" / "s104" / \
        "progress.txt"
    _, _, c = band.read_progress(port)
    got = band.seed_stats(port, 200)["backup_steps_by_window"]
    assert got == pytest.approx([c["backup_steps"][i:i + 50].mean()
                                 for i in range(0, 200, 50)], rel=1e-12)
    got = judge("unicycle", as_port(tmp_path, {s: files[s] for s in
                                               band.BAND_SEEDS}), tmp_path)
    assert got["mann_whitney_u_violations"]["n_port"] == 12
