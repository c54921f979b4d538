"""The port's ``CCT_SANITIZE=1`` stage guard (``utils/sanitize``), on the CPU.

- Unarmed, every guard is a no-op; armed on the CPU (no card), a
  ``sync_probe`` planted inside a guarded stage raises
  ``StageTransferError`` (nothing synchronises there, so the probe stands
  for the sync it plants), and does not inside ``allow_transfer`` or
  outside a stage.
- The process-wide sync debug mode: with ``torch.cuda``'s mode calls
  faked, a guarded card stage arms ``"error"``, a sanctioned
  ``allow_transfer`` region (on any thread) lowers it to the mode saved
  before the first guard, nested guards restore that mode only when the
  last closes, and a synchronising-call error inside the stage surfaces as
  ``StageTransferError``.
- ``CCT_SANITIZE=1 consensus`` on ``sample.bam`` keeps the goldens on both
  wires, and with ``CCT_FAULTS=sscs.sync_probe=fail`` the planted sync
  fails the run with ``StageTransferError`` — on the stream wire and the
  dense wire (the probe sits in the dense wire's ``on_batch``).
"""

import json
import os
import threading

import pytest
import torch

from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.utils import sanitize
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)


def test_unarmed_guard_is_a_no_op(monkeypatch):
    monkeypatch.delenv("CCT_SANITIZE", raising=False)
    monkeypatch.setenv("CCT_FAULTS", "x.probe=fail@5")
    with sanitize.guarded_stage("sscs", torch.device("cpu")):
        sanitize.sync_probe("x.probe")
        with sanitize.allow_transfer("upload"):
            pass
    with pytest.raises(ValueError):
        with sanitize.allow_transfer(" "):
            pass


def test_planted_sync_raises_inside_a_cpu_stage_only(monkeypatch):
    monkeypatch.setenv("CCT_SANITIZE", "1")
    monkeypatch.setenv("CCT_FAULTS", "x.probe=fail@4")
    sanitize.sync_probe("x.probe")  # outside a stage: a harmless sync
    with sanitize.guarded_stage("sscs", torch.device("cpu")):
        with sanitize.allow_transfer("batch download"):
            sanitize.sync_probe("x.probe")  # sanctioned region
        with pytest.raises(sanitize.StageTransferError, match="guarded stage 'sscs'"):
            sanitize.sync_probe("x.probe")
    sanitize.sync_probe("x.probe")  # budget of 4 spent, stage closed: nothing
    sanitize.sync_probe("x.probe")


class _FakeMode:
    def __init__(self, start=0):
        self.mode = start
        self.history = []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.history.append(self.mode)


def test_card_guard_arms_and_restores_the_process_mode(monkeypatch):
    monkeypatch.setenv("CCT_SANITIZE", "1")
    fake = _FakeMode(start=1)  # someone runs with "warn" already
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    card = torch.device("cuda", 0)
    with sanitize.guarded_stage("sscs", card):
        assert fake.mode == 2
        with sanitize.guarded_stage("dcs", card):  # nested (another stage or thread)
            assert fake.mode == 2
            with sanitize.allow_transfer("batch upload, vote and download"):
                assert fake.mode == 1
            assert fake.mode == 2
        assert fake.mode == 2  # the outer guard is still open
        # a sanctioned region on ANOTHER thread lowers the mode for all
        seen = []
        release = threading.Event()
        entered = threading.Event()

        def other():
            with sanitize.allow_transfer("writer thread download"):
                entered.set()
                release.wait(5)

        t = threading.Thread(target=other)
        t.start()
        entered.wait(5)
        seen.append(fake.mode)
        release.set()
        t.join()
        seen.append(fake.mode)
        assert seen == [1, 2]
        with pytest.raises(sanitize.StageTransferError, match="synchronising CUDA call"):
            with sanitize.guarded_stage("inner", card):
                raise RuntimeError("called a synchronizing CUDA operation")
        with pytest.raises(KeyError):  # other errors pass through untouched
            with sanitize.guarded_stage("inner", card):
                raise KeyError("x")
    assert fake.mode == 1  # the saved mode is back
    # a CPU stage never touches the card's mode
    fake.history.clear()
    with sanitize.guarded_stage("sscs", torch.device("cpu")):
        with sanitize.allow_transfer("x"):
            pass
    assert fake.history == []


@pytest.mark.parametrize("wire", ["stream", "dense"])
def test_sanitized_consensus_keeps_goldens_and_catches_a_planted_sync(tmp_path, monkeypatch,
                                                                       wire):
    monkeypatch.setenv("CCT_SANITIZE", "1")
    monkeypatch.delenv("CCT_FAULTS", raising=False)
    argv = ["consensus", "-i", SAMPLE, "-n", "golden", "--device", "cpu", "--wire", wire]
    torch_cli.main([*argv, "-o", str(tmp_path / "ok")])
    assert golden_mismatches(str(tmp_path / "ok" / "golden"), GOLDEN["consensus"]) == []
    monkeypatch.setenv("CCT_FAULTS", "sscs.sync_probe=fail@1")
    with pytest.raises(sanitize.StageTransferError, match="sscs.sync_probe"):
        torch_cli.main([*argv, "-o", str(tmp_path / "planted")])
    assert not (tmp_path / "planted" / "golden" / "sscs" / "golden.sscs.sorted.bam").exists()
