"""The port's bundled demo (hybridsearch_tpu_torch/demo.py) end to end on
the CPU, with the assertions of tests/test_demo.py: the four demos run and
the ML query surfaces the ML document. Without a card its default device
raises instead of falling back to the CPU."""

import pytest
import torch


def test_demo_runs_end_to_end(capsys):
    from hybridsearch_tpu_torch.demo import run_demo

    run_demo(device="cpu")
    out = capsys.readouterr().out
    assert "basic hybrid search" in out
    assert "learned weights after 10 positive ratings" in out
    assert "multi-stage funnel" in out
    assert "MMR diversity" in out
    assert "demo complete" in out
    assert "Machine learning models learn patterns" in out


def test_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from hybridsearch_tpu_torch.demo import run_demo

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_demo()


def test_cli_demo_subcommand(capsys):
    from hybridsearch_tpu_torch.api.cli import main

    assert main(["--device", "cpu", "demo"]) == 0
    assert "demo complete" in capsys.readouterr().out
