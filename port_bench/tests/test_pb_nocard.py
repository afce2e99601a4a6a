"""A run without the card the cell asks for fails and prints no result."""
import subprocess
import sys

from port_bench.lib import spec


def test_no_card_no_result(monkeypatch, capsys):
    from port_bench import run
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "live.serve_b16", "--seed", "3",
                     "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_too_few_cards(monkeypatch, capsys):
    from port_bench import run
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run.torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "live.train_b16", "--seed", "3",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_the_command_without_a_card():
    """The command as the benchmark states it, in a process of its own."""
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "live.frame_b1",
         "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(spec.ROOT)})
    assert proc.returncode != 0 and proc.stdout == ""
