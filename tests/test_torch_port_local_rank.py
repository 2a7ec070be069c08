"""A local card for each process (`parallel.mesh.local_rank`,
`rank_device`): the card its launcher names on its host
(`SIN3DM_LOCAL_RANK`, else torchrun's `LOCAL_RANK`), else rank % the
host's cards; on fabricated environments and a fabricated four-card
host (a `torch.device` needs no card to exist)."""

import pytest
import torch

from sin3dm_tpu_torch.parallel import mesh


@pytest.fixture
def four_cards(monkeypatch):
    for name in mesh.LOCAL_RANK_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    return monkeypatch


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"LOCAL_RANK": "3"}, ("LOCAL_RANK", 3)),
    ({"SIN3DM_LOCAL_RANK": "1"}, ("SIN3DM_LOCAL_RANK", 1)),
    ({"SIN3DM_LOCAL_RANK": "2", "LOCAL_RANK": "0"},
     ("SIN3DM_LOCAL_RANK", 2)),
    ({"SIN3DM_LOCAL_RANK": "", "LOCAL_RANK": "2"}, ("LOCAL_RANK", 2)),
])
def test_local_rank_from_the_environment(four_cards, env, want):
    for k, v in env.items():
        four_cards.setenv(k, v)
    assert mesh.local_rank() == want


@pytest.mark.parametrize("rank,local,want", [
    (0, None, 0), (5, None, 1), (7, None, 3),     # rank % 4 cards
    (0, 3, 3), (6, 0, 0), (2, 2, 2)])            # the local index wins
def test_rank_device_takes_the_local_index(four_cards, rank, local, want):
    assert mesh.rank_device(rank, "cuda", local) == torch.device("cuda",
                                                                 want)
    assert mesh.rank_device(rank, "cpu", local) == torch.device("cpu")


@pytest.mark.parametrize("local", [4, -1])
def test_a_local_index_past_the_cards_raises(four_cards, local):
    with pytest.raises(ValueError, match="4 card"):
        mesh.rank_device(0, "cuda", local)


def test_no_card_still_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device(0, "cuda", 0)
