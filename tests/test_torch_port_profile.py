"""``nlbac-train-torch --profile_dir`` on the CPU: the CLI writes a
``torch.profiler`` Chrome trace of the second episode the process runs,
and of no other, on a fresh start (episode 1) and under ``--resume``
(the episode after the resumed one). Episodes are cut to a few steps so
each trace stays small. No tolerance: the trace's file name and events
are checked.
"""

import json

from nlbac_tpu_torch.train import cli

FLAGS = ["--preset", "unicycle", "--cpu", "--quiet", "--max_episode_steps",
         "8", "--batch_size", "12", "--updates_per_step", "1",
         "--start_steps", "6", "--hidden_size", "8", "--replay_size", "200",
         "--seed", "1"]


def _trace(prof_dir):
    (path,) = prof_dir.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    return path.name


def test_profile_dir_traces_the_second_episode(tmp_path):
    out, prof = tmp_path / "out", tmp_path / "prof"
    cli.main(FLAGS + ["--max_episodes", "3", "--output", str(out),
                      "--profile_dir", str(prof)])
    assert _trace(prof) == "episode1.trace.json"

    (run,) = out.glob("unicycle-run*/*/*_s1")
    prof2 = tmp_path / "prof_resumed"
    cli.main(FLAGS + ["--max_episodes", "5", "--output", str(out),
                      "--resume", str(run / "checkpoint.npz"),
                      "--profile_dir", str(prof2)])
    # resumed at episode 3: the second episode of this process is 4
    assert _trace(prof2) == "episode4.trace.json"
