"""The port's launchers against the JAX package's: ``launch/serve.py``,
``launch/train.py`` on the host mesh and under ``--production``, and
``launch/dryrun.py``.

The serve launcher's counts (sequences, blocks in use, table lookups)
depend on the paged KV cache and the fork pattern alone, so at the same
arguments they must be JAX's exactly. The dry-run joins a fake process
group, which cannot share a process with a real one: it runs as its own
process here, as it does everywhere.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_COUNTS = re.compile(r"(\d+) sequences .*\nblocks in use: (\d+) .*"
                     r"table lookups: (\d+)")


def _counts(text: str):
    m = _COUNTS.search(text)
    assert m, text
    return tuple(int(x) for x in m.groups())


@pytest.mark.parametrize("argv", [
    [],
    ["--vanilla"],
    ["--arch", "qwen2-moe-a2.7b", "--requests", "3", "--forks", "3",
     "--tokens", "5", "--prompt-len", "13"],
    ["--arch", "qwen2.5-3b", "--vanilla", "--requests", "2", "--tokens", "6"],
], ids=["direct", "vanilla", "moe", "qwen2.5-3b"])
def test_serve_launcher_counts_equal_jax(capsys, monkeypatch, argv):
    st = t_serve.main(argv + ["--device", "cpu"])
    port = _counts(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    assert port == _counts(capsys.readouterr().out)
    assert (st["n_seqs"], st["blocks_in_use"], st["lookups"]) == port
    steps = int(argv[argv.index("--tokens") + 1]) if "--tokens" in argv else 8
    # every sequence: its prompt's first token, then one a step
    assert len(st["tokens"]) == port[0]
    assert all(len(t) == steps + 1 for t in st["tokens"].values())


def test_serve_launcher_fused_path_same_tokens(capsys):
    """``--decode-path fused`` (128 blocks a sequence) gives the tables
    path's tokens and counts."""
    tables = t_serve.main(["--device", "cpu", "--max-blocks-per-seq", "128",
                           "--decode-path", "tables", "--tokens", "4"])
    fused = t_serve.main(["--device", "cpu", "--max-blocks-per-seq", "128",
                          "--decode-path", "fused", "--tokens", "4"])
    assert fused["tokens"] == tables["tokens"]
    assert fused["blocks_in_use"] == tables["blocks_in_use"]
    capsys.readouterr()


def test_train_launcher_on_host_mesh(capsys):
    """The launcher trains under the host mesh's rules, prints the JAX
    launcher's ``mesh:`` line, and leaves no group behind it."""
    assert not dist.is_initialized()
    report = t_train.main(["--scale", "smoke", "--device", "cpu", "--steps", "3",
                           "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1}  device: cpu  arch: qwen2.5-3b" in out
    assert "done: loss" in out and report["steps"] == 3
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-base"])
def test_trainer_on_host_mesh_equals_plain(arch):
    """What the launcher trains: the state and every batch placed as
    ``DTensor``s by the host mesh's rules. On one rank each step's loss,
    the trained state and every saved page are bitwise the plain
    ``Trainer``'s, and ``resume`` places the restored state again."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    cfg = smoke_config(arch)

    def trainer(rules=None):
        return Trainer(get_model(cfg), AdamWConfig(lr=1e-3, total_steps=3),
                       DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2),
                       TrainerConfig(total_steps=3, ckpt_every=1),
                       device="cpu", rules=rules)

    plain = trainer()
    plain.run()
    rules = sh.make_rules(make_host_mesh(device="cpu"))
    try:
        with sh.use_rules(rules):
            placed = trainer(rules)
            assert all(isinstance(x, DTensor) for x in leaves(placed.params))
            placed.run()
            assert placed.losses == plain.losses
            for a, b in zip(leaves(placed._state()), leaves(plain._state())):
                assert torch.equal(a, b)
            assert torch.equal(placed.ckpt.chain.pool, plain.ckpt.chain.pool)
            assert placed.resume() == 3
            for a, b in zip(leaves(placed.params), leaves(plain.params)):
                assert isinstance(a, DTensor) and torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()


_ARGV = ["--scale", "smoke", "--device", "cpu", "--steps", "3", "--seq", "16",
         "--batch", "4", "--ckpt-every", "1"]


def _launcher_worker(rank, world, store_path, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        report = t_train.main(_ARGV)
        Path(out_dir, f"r{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def test_train_launcher_on_two_ranks(tmp_path, capfd):
    """The launcher on two spawned gloo ranks: the host mesh is (data=1,
    model=2), so the state is split over the model axis and the step runs
    its collectives. Both ranks report the same loss, and it is the plain
    ``Trainer``'s within 1e-4 relative (the compute is bf16 and the
    model-axis sums split in two)."""
    import torch.multiprocessing as mp

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mp.spawn(_launcher_worker, args=(2, str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    r0, r1 = (json.loads((tmp_path / f"r{r}.json").read_text()) for r in (0, 1))
    assert r0 == r1 | dict(goodput=r0["goodput"])
    cfg = smoke_config("qwen2.5-3b")
    plain = Trainer(get_model(cfg), AdamWConfig(lr=1e-3, total_steps=3),
                    DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4),
                    TrainerConfig(total_steps=3, ckpt_every=1),
                    device="cpu").run()
    assert r0["final_loss"] == pytest.approx(plain["final_loss"], rel=1e-4)
    assert r0["ckpt_chain_length"] == plain["ckpt_chain_length"]
    out = capfd.readouterr().out
    assert out.count("mesh: {'data': 1, 'model': 2}  device: cpu") == 2


def test_production_refuses_on_one_rank():
    with pytest.raises(RuntimeError, match=r"needs 256 ranks; the world has 1"):
        t_train.main(["--production", "--device", "cpu", "--steps", "1"])
    assert not dist.is_initialized()


def test_dryrun_smoke_cell_in_subprocess(tmp_path):
    """A smoke cell traced by ``python -m repro_torch.launch.dryrun`` on a
    fake (2, 4) group: its record has every field, and the model FLOPs
    are JAX's formula (6 · active params · tokens to train)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = tmp_path / "dry"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "qwen2.5-3b", "--shape", "train_4k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done. failures=0" in proc.stdout
    rec = json.loads((out / "qwen2.5-3b__train_4k__2x4.json").read_text())
    for key in ("arch", "shape", "mesh", "n_devices", "kind", "accum",
                "trace_s", "memory", "flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device", "model_flops_total",
                "model_flops_per_device", "useful_flops_ratio",
                "roofline_terms_s", "bottleneck", "roofline_frac"):
        assert key in rec, key
    assert rec["n_devices"] == 8 and rec["mesh"] == "2x4" and rec["accum"] == 4
    assert set(rec["collective_bytes_per_device"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "point-to-point", "total"}
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert rec["flops_per_device"] > rec["model_flops_per_device"] > 0
    assert set(rec["roofline_terms_s"]) == {"compute_s", "memory_s",
                                            "collective_s"}
    n_active = j_smoke("qwen2.5-3b").active_param_count()
    assert rec["model_flops_total"] == 6.0 * n_active * 256 * 4096
    assert rec["model_flops_per_device"] == rec["model_flops_total"] / 8
