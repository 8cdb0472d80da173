"""The port's Test_AddMul and Test_General CLIs on --device=cpu, mirrors of
tests/test_addmul.py (the same circuit and seeds, through the CLI) and
tests/test_extension_slots.py::test_general_cli_extension_config; each
CLI holds its decrypts against the plaintext arithmetic of the port's
oracle (tests/test_torch_host.py holds that equal to fhe_si_tpu's).  And
the refusal of every port CLI to start without CUDA unless given
--device=cpu."""
import importlib

import pytest
import torch

from fhe_si_tpu_torch.cli import test_addmul, test_general

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_addmul_cli_circuit(seed, capsys):
    """m = p - 1 = 22: Add, the 7-fold add, Multiply, Squaring and
    Sum-and-quad all decrypt right."""
    argv = ["test_addmul", "80", "23", "7", str(1000 + seed)]
    assert test_addmul.main(argv + ["--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "Test SUCCEEDED" in out and "failed" not in out


def test_addmul_cli_trials(capsys):
    """The trial loop (seeds from the clock) exits with 0 failures."""
    argv = ["test_addmul", "80", "23", "7", "--trials", "3", "--device=cpu"]
    assert test_addmul.main(argv) == 0
    assert capsys.readouterr().out.rstrip().endswith("All tests SUCCEEDED!")


@pytest.mark.parametrize("args", [["23", "7", "80", "1234"],
                                  ["2", "3", "80", "1234", "--m=31"]],
                         ids=["m22", "m31-p2-d5"])
def test_general_cli(args, capsys):
    assert test_general.main(["test_general", *args, "--device=cpu"]) == 0
    assert capsys.readouterr().out.strip() == "All tests finished."


@pytest.mark.parametrize("name,argv", [
    ("test_addmul", ["80", "23", "7", "3"]),
    ("test_general", ["23", "7", "80", "3"]),
    ("test_regression", ["data.txt", "97", "3", "3", "--m=32"]),
    ("test_statistics", ["data.txt", "97", "3", "3", "--m=32"]),
])
def test_cli_refuses_without_cuda(name, argv, monkeypatch, capsys):
    """Without a card the default --device=cuda:0 exits 1 with the reason
    before any work; --device=cpu is the only way onto the CPU."""
    cli = importlib.import_module(f"fhe_si_tpu_torch.cli.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([name, *argv]) == 1
    captured = capsys.readouterr()
    assert "CUDA is not available; pass --device=cpu" in captured.err
    assert captured.out == ""
