"""The int8 block's variant tool (``int8_variants.py``) on the CPU: every
variant is an edit that applies to ``csrc/conv3x3_int8.cu`` and changes
it, the N = 256 wrapper it generates numbers its operands as the source's
own instances do, and without a card the tool exits 1. Its builds and
timings run on the card only."""

import pytest
import torch

from pytorch_camvid_tpu_torch import int8_variants as iv
from pytorch_camvid_tpu_torch.ops import fused_conv_int8 as fq


@pytest.mark.parametrize("name", sorted(iv.VARIANTS))
def test_variant_edits_apply(name):
    src = iv._edited(iv.VARIANTS[name])
    assert (src == fq.SOURCE.read_text()) == (name == "kept")


@pytest.mark.parametrize("n", [64, 128])
def test_generated_wgmma_wrapper_numbers_operands_as_the_source(n):
    """The generator's predicate, A, descriptor and accumulator operands
    for N = 64 and 128 are the source's own instances'; N = 256 goes the
    same way."""
    k = n // 2
    src = fq.SOURCE.read_text()
    got = iv._wgmma_s8(n)
    for part in (f"setp.ne.b32 p, %{k + 5}, 0;",
                 f"m64n{n}k32.s32.s8.s8",
                 f"%{k}, %{k + 1}, %{k + 2}, %{k + 3}}}, %{k + 4}, p;",
                 f'"+r"(d[{k - 1}])', f"int (&d)[{k}]"):
        assert part in got and part in src, part


def test_block_shapes_are_phase_16s():
    shapes = iv.block_shapes()
    assert len(shapes) == 19 and (360, 480, 3, 64) in shapes
    assert all(cout >= iv.MIN_COUT for *_, cout in shapes)


def test_without_a_card_it_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert iv.main(["kept"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_parent_packed_layout_follows_its_packed_k():
    """A parent library whose packed K is 9 x Cin rounded (PR 21's) gets
    k = tap * Cin + ci; one whose K is this source's gets ``pack_weights``;
    the wgmma path's layout is the same for both."""
    w_q = torch.randint(-127, 128, (3, 3, 3, 8), dtype=torch.int8,
                        generator=torch.Generator().manual_seed(0))

    class Lib:
        def __init__(self, kp):
            self.conv3x3_int8_packed_k = lambda cin: kp
    old = iv._packed(Lib(32), w_q)
    assert old.shape == (8, 32)
    assert torch.equal(old[:, :27], w_q.reshape(27, 8).t())
    assert not old[:, 27:].any()
    assert torch.equal(iv._packed(Lib(fq.packed_k(3)), w_q),
                       fq.pack_weights(w_q))
    w64 = torch.zeros((3, 3, 64, 8), dtype=torch.int8)
    assert torch.equal(iv._packed(Lib(0), w64), fq.pack_weights(w64))


def test_unknown_variant_is_refused():
    with pytest.raises(SystemExit):
        iv.main(["no_such_variant"])
