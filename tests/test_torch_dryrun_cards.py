"""The dry run across cards, on a host without them: `run_cards` and
`main --device cuda --world N` raise before any rank starts when fewer than
N cards are visible, and `check_placement` holds rank r to card r."""

import copy

import pytest
import torch

from halo2_aggregation_tpu_torch.tools import dryrun_multichip as dm

torch.set_num_threads(1)


def _placement(r: int) -> dict:
    """The placement record of a rank that ran on card r only."""
    events = {name: [r] for name in ("all", *dm.LIBRARY_KERNELS)}
    return {"current_device": r, "tensor_devices": [r], "events": {"shmap": events, "sharded": dict(events)}}


def _ranks(world: int) -> list:
    """`rank_run`'s records with `placement`, two meshes a rank."""
    return [[{"mesh": mesh, "placement": _placement(r)} for mesh in ([2, 2], [4, 1])] for r in range(world)]


def test_run_cards_raises_before_any_rank_without_cards(monkeypatch):
    """On a host with fewer cards than the world (one, here, whatever the
    host has), `run_cards` raises ValueError naming both numbers before it
    touches its arguments; world 1 is `run_card`'s."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="world 4 needs one card a rank, 1 visible"):
        dm.run_cards(None, None, None, [], 4)
    with pytest.raises(ValueError, match="world 1: expected 2 or more cards"):
        dm.run_cards(None, None, None, [], 1)


def test_main_world_4_raises_before_any_proof(monkeypatch):
    """`--device cuda --world 4` with fewer cards (one, here) raises
    ValueError before the host proofs are made (and so before any spawn)."""
    def no_proofs(k):
        raise AssertionError("make_proofs ran")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dm, "make_proofs", no_proofs)
    with pytest.raises(ValueError, match="world 4 needs one card a rank, 1 visible"):
        dm.main(["--device", "cuda", "--world", "4"])


def test_check_placement_accepts_rank_r_on_card_r():
    dm.check_placement(_ranks(4), 4)


@pytest.mark.parametrize("field", ["current_device", "tensor_devices", "all", "ec_win_kernel"])
def test_check_placement_refuses_rank_1_on_card_0(field):
    """Rank 1 that saw card 0, in any one of the records, is refused: its
    current device, a returned tensor, any CUDA event, a K1 launch."""
    ranks = copy.deepcopy(_ranks(4))
    where = ranks[1][1]["placement"]
    if field == "current_device":
        where[field] = 0
    elif field == "tensor_devices":
        where[field] = [0, 1]
    else:
        where["events"]["sharded"][field] = [0]
    with pytest.raises(AssertionError, match=r"rank 1, mesh \[4, 1\]: .* on cards \[0.*want \[1\]"):
        dm.check_placement(ranks, 4)


def test_check_placement_refuses_missing_launches_and_ranks():
    """A profile with no launch of a main-path kernel proves nothing, and
    neither does a missing rank."""
    ranks = _ranks(2)
    ranks[0][0]["placement"]["events"]["shmap"]["fa_tape_kernel"] = []
    with pytest.raises(AssertionError, match=r"fa_tape_kernel events on cards \[\]"):
        dm.check_placement(ranks, 2)
    with pytest.raises(AssertionError, match="3 ranks' records, world 4"):
        dm.check_placement(_ranks(3), 4)
