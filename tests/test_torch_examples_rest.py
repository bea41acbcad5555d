"""The other example twins on the CPU: ``train_small_torch`` runs to its
end at a small size, ``multipod_dryrun_torch`` writes the reference's
status and argument bytes for the default multi-pod cell,
``quickstart_torch`` prints the reference's lines, and a serving twin
asked for no device refuses to run without a card rather than run on the
CPU."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

import torch_examples as E  # noqa: E402

# command-r-35b x decode_32k on the 2x16x16 mesh: rank 0's params and
# cache, the same in both packages
MULTIPOD_ARGUMENT_BYTES = 2_166_636_564


def test_train_small_twin_runs_to_its_end(tmp_path, capsys):
    losses = E.twin("train_small").main(
        ["--arch", "micro", "--steps", "3", "--batch", "2", "--seq", "32",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 3 and all(map(torch.isfinite, map(torch.tensor,
                                                              losses)))
    assert out[-1] == (f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} (3 "
                       f"steps); checkpoints in {tmp_path / 'ckpt'}")


def test_train_small_twin_keeps_its_own_checkpoints(monkeypatch):
    """Its resume must not find the reference example's checkpoints; it
    trains on the card unless asked for the CPU."""
    import argparse
    seen = {}

    def parse(self, argv=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(SystemExit):
        E.twin("train_small").main([])
    assert seen["ckpt_dir"] == "/tmp/repro_torch_ckpt"
    assert seen["device"] == "cuda"


def test_multipod_twin_writes_the_reference_s_cell(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    E.run_reference("multipod_dryrun", cwd=tmp_path / "ref")
    res = E.run_port_child("multipod_dryrun", cwd=tmp_path / "port")
    assert res.returncode == 0, res.stderr[-3000:]
    name = "demo.command-r-35b.decode_32k.multi.json"
    ref = json.loads((tmp_path / "ref" / "benchmarks" / "results" / "dryrun"
                      / name).read_text())
    got = json.loads((tmp_path / "port" / "build" / "dryrun"
                      / name).read_text())
    assert got["status"] == ref["status"] == "ok"
    assert got["mesh"] == [2, 16, 16]
    assert got["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"] == MULTIPOD_ARGUMENT_BYTES
    assert E.chip_smoke().MULTIPOD_ARGUMENT_BYTES == MULTIPOD_ARGUMENT_BYTES


def test_quickstart_twin_prints_the_reference_s_lines():
    want = E.run_reference("quickstart")
    res = E.run_port_child("quickstart")
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines() == want


@pytest.mark.parametrize("name", ["serve_agents", "train_small"])
def test_twin_without_a_device_refuses_to_run_on_the_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    res = E.run_port_child(name, *(["--ckpt-dir", str(tmp_path)]
                                   if name == "train_small" else []))
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not res.stdout.strip()
