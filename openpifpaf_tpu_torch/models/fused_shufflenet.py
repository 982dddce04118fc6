"""Execution plans for ShuffleNetV2K: the pair plan and the r3 plan, for
inference and for training.

Port of ``openpifpaf_tpu/models/fused_shufflenet.py``.  Every plan computes
the math of the canonical ``ShuffleNetV2K`` (``shufflenetv2k.py``) from its
parameters, which stay the weight holder; only the execution differs.  The
training plans are at the end of the file (``shell_apply_train``).

- **The pair plan** (``backbone_apply_pair``, ``fused_shufflenet.py:331-482``)
  carries each stage as a parity pair ``(a, b)`` with ``logical =
  interleave(a, b)``, so the ``channel_shuffle`` never materializes: 1x1
  convs take the kernel rows by parity (``_mm_pair``), depthwise convs the
  channels by parity (``_dw_pair``), and a stride-1 block touches only
  ``a[q:]``, ``b[q:]`` and rebuilds ``x1 = interleave(a[:q], b[:q])``.  Each
  stage's consecutive stride-1 blocks run as one chain through
  ``ops.pair_chain.apply_chain``: the CUDA kernel K2 on the card, its plain
  version on the CPU.  It needs every stage's half-width to be even
  (``supports_pair``).
- **The r3 plan** (``backbone_apply``, ``fused_shufflenet.py:87-120,
  283-306``), for the widths the pair plan cannot take, keeps the stage
  dense and applies the shuffle by indexing.  It runs on library calls
  only.

Inference BatchNorm is folded once per model (``fold``), computed in
float64 and applied in float32 like ``ops.pair_chain.fold_bn``.  Inside K2
the folded scale and bias stay separate vectors, as in the JAX package's
``BlockParams``.  Outside K2 (conv1, the stride-2 blocks, conv5) they are
folded into the conv weights and a bias, so each conv and its BatchNorm is
one library call (cuDNN, ``torch.addmm``); ``_bn_pair`` of the JAX package
becomes the parity split of such a fold.  The stage state runs channels-last
``(B, H, W, C)`` in the plan's ``dtype`` (JAX's ``module.dtype``): converted
once after conv1, and the features leave as ``(B, H, W, C)``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Union

import torch
import torch.nn.functional as F

from .shufflenetv2k import ShuffleNetV2K
from ..ops import pair_chain as pc


class Affine(NamedTuple):
    """A conv with its BatchNorm folded in: ``conv(x, weight) + bias``.  A
    1x1 conv's weight is the (in, out) matmul weight."""

    weight: torch.Tensor
    bias: torch.Tensor


class PairAffine(NamedTuple):
    """A 1x1 conv on a parity pair: ``a @ wa + b @ wb + bias``."""

    wa: torch.Tensor
    wb: torch.Tensor
    bias: torch.Tensor


class Plan(NamedTuple):
    """A backbone's folded inference parameters (see ``fold``)."""

    dtype: torch.dtype
    pair: bool
    conv1: Affine
    blocks: Dict[str, dict]                  # stride-2 (both plans), stride-1 (r3)
    chains: Dict[int, pc.PackedChain]        # pair plan: stage -> stride-1 chain
    conv5: Union[Affine, PairAffine]


def supports(module) -> bool:
    """The fused plans cover the batchnorm ShuffleNetV2K backbones."""
    return isinstance(module, ShuffleNetV2K) and module.norm == 'batchnorm'


def supports_pair(module) -> bool:
    """Pair-plan eligibility: every stage half-width must be even, and the
    depthwise kernels 5x5 (K2's stencil)."""
    if not supports(module) or module.kernel_size != 5:
        return False
    return all((c // 2) % 2 == 0 for c in module.stages_out_channels[1:4])


# ------------------------------------------------------------------ folding
def _fold_conv(conv, bn, dtype) -> Affine:
    """A conv (OIHW) and its BatchNorm -> folded OIHW weight and bias."""
    scale, bias = pc.fold_bn(bn)
    weight = conv.weight.detach().float() * scale.view(-1, 1, 1, 1)
    return Affine(weight.to(dtype), bias.to(dtype))


def _fold_matmul(conv, bn, dtype) -> Affine:
    """A 1x1 conv and its BatchNorm -> folded (in, out) weight and bias."""
    scale, bias = pc.fold_bn(bn)
    weight = conv.weight.detach()[:, :, 0, 0].t().float() * scale
    return Affine(weight.to(dtype).contiguous(), bias.to(dtype))


def _split_matmul(aff: Affine) -> PairAffine:
    """The kernel rows by parity, for an input held as a pair."""
    return PairAffine(aff.weight[0::2].contiguous(),
                      aff.weight[1::2].contiguous(), aff.bias)


def _split_dw(aff: Affine):
    """A depthwise conv's channels by parity, for an input held as a pair."""
    return (Affine(aff.weight[0::2].contiguous(), aff.bias[0::2].contiguous()),
            Affine(aff.weight[1::2].contiguous(), aff.bias[1::2].contiguous()))


def _fold_branch2(block, dtype) -> dict:
    return dict(b2_mm1=_fold_matmul(block.branch2_conv1, block.branch2_norm1,
                                    dtype),
                b2_dw=_fold_conv(block.branch2_dwconv, block.branch2_dwnorm,
                                 dtype),
                b2_mm2=_fold_matmul(block.branch2_conv2, block.branch2_norm2,
                                    dtype))


def _fold_stride2(block, dtype, pair_input: bool) -> dict:
    f = _fold_branch2(block, dtype)
    f['b1_dw'] = _fold_conv(block.branch1_dwconv, block.branch1_dwnorm, dtype)
    f['b1_mm'] = _fold_matmul(block.branch1_conv, block.branch1_norm, dtype)
    if pair_input:
        f['b1_dw'] = _split_dw(f['b1_dw'])
        f['b1_mm'] = _split_matmul(f['b1_mm'])
        f['b2_mm1'] = _split_matmul(f['b2_mm1'])
    return f


@torch.no_grad()
def fold(module: ShuffleNetV2K, dtype: torch.dtype = torch.float32,
         pair: bool = None) -> Plan:
    """Fold the backbone's inference parameters for the pair plan (default
    where ``supports_pair``) or the r3 plan, in ``dtype`` on the module's
    device.  Fold again after the weights change."""
    if not supports(module):
        raise ValueError(f'no fused plan for {type(module).__name__}')
    pair = supports_pair(module) if pair is None else pair
    if pair and not supports_pair(module):
        raise ValueError('the pair plan needs even stage half-widths, got '
                         f'{module.stages_out_channels[1:4]}')
    blocks, chains = {}, {}
    for stage_i, repeats in enumerate(module.stages_repeats, start=2):
        name = f'stage{stage_i}_0'
        blocks[name] = _fold_stride2(getattr(module, name), dtype,
                                     pair and stage_i > 2)
        stride1 = [getattr(module, f'stage{stage_i}_{bi}')
                   for bi in range(1, repeats)]
        if pair and stride1:
            chains[stage_i] = pc.pack([pc.block_params(b) for b in stride1],
                                      dtype)
        elif stride1:
            for bi, block in enumerate(stride1, start=1):
                blocks[f'stage{stage_i}_{bi}'] = _fold_branch2(block, dtype)
    conv5 = _fold_matmul(module.conv5, module.conv5_norm, dtype)
    return Plan(dtype=dtype, pair=pair,
                conv1=_fold_conv(module.conv1, module.conv1_norm, dtype),
                blocks=blocks, chains=chains,
                conv5=_split_matmul(conv5) if pair else conv5)


# -------------------------------------------------------------- operations
def _mm(x: torch.Tensor, aff: Affine) -> torch.Tensor:
    """``x @ weight + bias`` over the last axis of a channels-last tensor."""
    y = torch.addmm(aff.bias, x.reshape(-1, x.shape[-1]), aff.weight)
    return y.view(*x.shape[:-1], y.shape[-1])


def _mm_pair(pair, aff: PairAffine) -> torch.Tensor:
    """``logical @ W + bias`` with the kernel rows gathered by parity."""
    a, b = pair
    y = torch.addmm(aff.bias, a.reshape(-1, a.shape[-1]), aff.wa)
    y = y.addmm_(b.reshape(-1, b.shape[-1]), aff.wb)
    return y.view(*a.shape[:-1], y.shape[-1])


def _dw(x: torch.Tensor, aff: Affine, stride: int) -> torch.Tensor:
    """Depthwise conv (SAME) of a channels-last tensor, plus bias."""
    k = aff.weight.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), aff.weight, aff.bias, stride, k // 2,
                 groups=x.shape[-1])
    return y.permute(0, 2, 3, 1).contiguous()


def _dw_pair(pair, affs, stride: int):
    """Depthwise conv of a logical pair: parity-sliced kernels."""
    return tuple(_dw(x, aff, stride) for x, aff in zip(pair, affs))


def _branch2(x, f, stride: int) -> torch.Tensor:
    """relu(bn(conv2(bn(dw(relu(bn(conv1(x)))))))) from its first product."""
    x = _dw(torch.relu_(x), f['b2_dw'], stride)
    return torch.relu_(_mm(x, f['b2_mm2']))


def _conv1(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """NCHW float images -> the channels-last stage-2 input in the plan's
    dtype."""
    x = x.to(plan.dtype).contiguous(memory_format=torch.channels_last)
    x = F.conv2d(x, plan.conv1.weight, plan.conv1.bias, 2, 1)
    return torch.relu_(x).permute(0, 2, 3, 1).contiguous()


def _block_stride2_pair(state, f):
    """Stride-2 InvertedResidualK; input dense (stage-2 entry) or a pair.
    Returns the pair ``(b1, b2)``: logical = interleave(b1, b2), no
    routing."""
    if isinstance(state, tuple):
        d1 = _dw_pair(state, f['b1_dw'], 2)
        b1 = _mm_pair(d1, f['b1_mm'])
        b2 = _mm_pair(state, f['b2_mm1'])
    else:
        b1 = _mm(_dw(state, f['b1_dw'], 2), f['b1_mm'])
        b2 = _mm(state, f['b2_mm1'])
    return torch.relu_(b1), _branch2(b2, f, 2)


def backbone_apply_pair(module: ShuffleNetV2K, x: torch.Tensor,
                        plan: Plan = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inference forward with symbolic routing (the pair plan): NCHW float
    images -> (B, H, W, C) features in the plan's dtype.  ``plan`` defaults
    to ``fold(module, dtype, pair=True)``."""
    plan = fold(module, dtype, pair=True) if plan is None else plan
    state = _conv1(x, plan)            # dense into stage 2
    for stage_i, repeats in enumerate(module.stages_repeats, start=2):
        state = _block_stride2_pair(state, plan.blocks[f'stage{stage_i}_0'])
        if repeats > 1:
            state = pc.apply_chain(*state, plan.chains[stage_i])
    # conv5 folds the final interleave for free
    return torch.relu_(_mm_pair(state, plan.conv5))


def _block_stride1(x, f):
    """Stride-1 InvertedResidualK on a dense state, the shuffle by
    indexing."""
    half = x.shape[-1] // 2
    b2 = _branch2(_mm(x[..., half:], f['b2_mm1']), f, 1)
    return pc.interleave(x[..., :half], b2)


def _block_stride2(x, f):
    """Stride-2 InvertedResidualK on a dense state."""
    return pc.interleave(*_block_stride2_pair(x, f))


def backbone_apply(module: ShuffleNetV2K, x: torch.Tensor, plan: Plan = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inference forward of the r3 plan (dense stages): NCHW float images
    -> (B, H, W, C) features.  ``plan`` defaults to ``fold(module, dtype,
    pair=False)``."""
    plan = fold(module, dtype, pair=False) if plan is None else plan
    x = _conv1(x, plan)
    for stage_i, repeats in enumerate(module.stages_repeats, start=2):
        x = _block_stride2(x, plan.blocks[f'stage{stage_i}_0'])
        for bi in range(1, repeats):
            x = _block_stride1(x, plan.blocks[f'stage{stage_i}_{bi}'])
    return torch.relu_(_mm(x, plan.conv5))


def backbone_features(module: ShuffleNetV2K, x: torch.Tensor,
                      plan: Plan = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused backbone forward ``plan`` was folded for: the pair plan
    when the widths allow, the r3 plan otherwise."""
    plan = fold(module, dtype) if plan is None else plan
    apply = backbone_apply_pair if plan.pair else backbone_apply
    return apply(module, x, plan)



# ---------------------------------------------------------------- training
# The training plans of ``fused_shufflenet.py:129-281`` (r3) and ``:485-607``
# (pair): the same routing folds as the inference plans, on the canonical
# parameters under autograd, with BatchNorm in batch mode through the
# Shell's own ``base.BatchNorm`` layers (``batch_forward``), so the running
# statistics move as in the canonical graph.  Nothing is folded ahead of
# time: every 1x1 conv reads its kernel as an (in, out) view of the
# parameter, the splits are strided views that the matmul reads in place,
# and a pair's parity halves take the kernel's rows, a depthwise kernel's
# channels and a BatchNorm's channels by parity.  So the gradients land on
# the canonical parameters, routed back through the same index maps.  The
# one materialization the JAX plans keep (the interleave of two halves,
# ``x @ Px + b2 @ Po`` there) is ``ops.pair_chain.interleave`` here: a
# copy, exact in every dtype (a 0/1 matmul would round under TF32).  State
# runs channels-last ``(B, H, W, C)``; under the trainer's bf16 autocast
# each matmul and conv computes in bf16 as the canonical graph's do.
def _kernel(conv) -> torch.Tensor:
    """A 1x1 conv's weight as the (in, out) matmul weight (a view)."""
    return conv.weight[:, :, 0, 0].t()


def _rows(x: torch.Tensor, channels: slice = slice(None)) -> torch.Tensor:
    """The (pixels, channels) rows of a contiguous channels-last tensor,
    a strided view for a channel slice."""
    return x.reshape(-1, x.shape[-1])[:, channels]


def _matmul(x: torch.Tensor, w: torch.Tensor,
            channels: slice = slice(None)) -> torch.Tensor:
    """``x[..., channels] @ w`` over the last axis."""
    return (_rows(x, channels) @ w).view(*x.shape[:-1], w.shape[-1])


def _matmul_pair(pair, w: torch.Tensor,
                 channels: slice = slice(None)) -> torch.Tensor:
    """``logical[..., channels] @ w`` of a pair: the kernel rows by
    parity (``channels`` of each half: a stride-1 block's split)."""
    a, b = pair
    return _matmul(a, w[0::2], channels) + _matmul(b, w[1::2], channels)


def _bn_train(bn, x: torch.Tensor, channels: slice = slice(None)):
    """Batch-mode BatchNorm of a channels-last tensor holding ``bn``'s
    ``channels``."""
    return bn.batch_forward(x.permute(0, 3, 1, 2), channels).permute(
        0, 2, 3, 1)


def _dw_train(x: torch.Tensor, conv, stride: int,
              channels: slice = slice(None)) -> torch.Tensor:
    """A depthwise conv (SAME) of a channels-last tensor holding ``conv``'s
    ``channels``."""
    weight = conv.weight[channels]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride,
                 weight.shape[-1] // 2, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def _branch2_train(b2, block, stride: int) -> torch.Tensor:
    """relu(bn(conv2(bn(dw(relu(bn(b2))))))) from branch2's first product."""
    b2 = torch.relu(_bn_train(block.branch2_norm1, b2))
    b2 = _bn_train(block.branch2_dwnorm,
                   _dw_train(b2, block.branch2_dwconv, stride))
    b2 = _matmul(b2.contiguous(), _kernel(block.branch2_conv2))
    return torch.relu(_bn_train(block.branch2_norm2, b2))


def _stem_train(module, x: torch.Tensor) -> torch.Tensor:
    """conv1, its BatchNorm and relu: NCHW images -> channels-last."""
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.conv2d(x, module.conv1.weight, None, 2, 1)
    x = torch.relu(module.conv1_norm.batch_forward(x))
    return x.permute(0, 2, 3, 1).contiguous()


def _head_train(module, state, pair: bool) -> torch.Tensor:
    """conv5 (folding the last interleave of a pair), BatchNorm, relu."""
    w = _kernel(module.conv5)
    x = _matmul_pair(state, w) if pair else _matmul(state, w)
    return torch.relu(_bn_train(module.conv5_norm, x))


def _block_stride2_train(state, block):
    """Stride-2 InvertedResidualK on a dense state (stage-2 entry, or every
    stage of the r3 plan) or a pair; returns the pair ``(b1, b2)``."""
    if isinstance(state, tuple):
        d1 = tuple(_bn_train(block.branch1_dwnorm,
                             _dw_train(x, block.branch1_dwconv, 2, side),
                             side).contiguous()
                   for x, side in zip(state, (slice(0, None, 2),
                                              slice(1, None, 2))))
        b1 = _matmul_pair(d1, _kernel(block.branch1_conv))
        b2 = _matmul_pair(state, _kernel(block.branch2_conv1))
    else:
        d1 = _bn_train(block.branch1_dwnorm,
                       _dw_train(state, block.branch1_dwconv, 2))
        b1 = _matmul(d1.contiguous(), _kernel(block.branch1_conv))
        b2 = _matmul(state, _kernel(block.branch2_conv1))
    b1 = torch.relu(_bn_train(block.branch1_norm, b1))
    return b1, _branch2_train(b2, block, 2)


def _block_stride1_pair_train(pair, block):
    """Stride-1 block on a pair: ``x2 = logical[half:]`` is ``a[q:]``,
    ``b[q:]`` with the kernel rows by parity; the new pair is
    ``(interleave(a[:q], b[:q]), b2)``."""
    a, b = pair
    q = a.shape[-1] // 2
    b2 = _matmul_pair(pair, _kernel(block.branch2_conv1), slice(q, None))
    return pc.interleave(a[..., :q], b[..., :q]), _branch2_train(b2, block, 1)


def _block_stride1_train(x, block):
    """Stride-1 block on a dense state (r3): the split a strided view, the
    concat and shuffle one interleave."""
    half = x.shape[-1] // 2
    b2 = _matmul(x, _kernel(block.branch2_conv1), slice(half, None))
    return pc.interleave(x[..., :half], _branch2_train(b2, block, 1))


def supports_pair_train(module) -> bool:
    """The pair training plan needs even stage half-widths (the JAX
    package's ``supports_pair``); it runs no K2, so any kernel size."""
    return (supports(module) and all(
        (c // 2) % 2 == 0 for c in module.stages_out_channels[1:4]))


def backbone_apply_train(module: ShuffleNetV2K,
                         x: torch.Tensor) -> torch.Tensor:
    """Training forward of the backbone through the pair plan where
    ``supports_pair_train``, else the r3 plan: NCHW images -> (B, H, W, C)
    features; updates the BatchNorm running statistics."""
    pair = supports_pair_train(module)
    state = _stem_train(module, x)
    for stage_i, repeats in enumerate(module.stages_repeats, start=2):
        state = _block_stride2_train(state, getattr(module,
                                                    f'stage{stage_i}_0'))
        if not pair:
            state = pc.interleave(*state)
        for bi in range(1, repeats):
            block = getattr(module, f'stage{stage_i}_{bi}')
            state = (_block_stride1_pair_train(state, block) if pair
                     else _block_stride1_train(state, block))
    return _head_train(module, state, pair)


def supports_train(shell) -> bool:
    """Training-plan eligibility (``fused_shufflenet.py:270-281``): a
    batchnorm ShuffleNetV2K shell without cross-talk or head dropout, whose
    only BatchNorm layers are the backbone's."""
    basenet = shell.basenet
    in_basenet = {id(m) for m in basenet.modules()}
    return (supports(basenet)
            and getattr(shell, 'cross_talk', 0.0) == 0.0
            and all(getattr(h, 'dropout', None) is None
                    for h in shell.head_nets)
            and all(id(m) in in_basenet for m in shell.modules()
                    if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)))


def shell_apply_train(shell, x: torch.Tensor) -> List[torch.Tensor]:
    """The Shell's train-mode forward through the training plan: NCHW
    images -> the head fields, with the backbone's running statistics
    updated; what ``shell(x)`` computes in train mode where
    ``supports_train(shell)``.  A tracking shell's paired heads see the
    channel-concatenated frame-pair features, as
    ``TrackingShell.heads_from_features``."""
    from .shell import apply_heads   # pylint: disable=import-outside-toplevel

    features = backbone_apply_train(shell.basenet, x)
    return apply_heads(shell.head_nets, features.permute(0, 3, 1, 2),
                       getattr(shell, 'head_paired', None))
