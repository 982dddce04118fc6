"""Model factory: build a fresh model or load a JAX-package checkpoint.

Port of the predict-path subset of ``openpifpaf_tpu/models/factory.py``
(``Factory.factory`` / ``build_module`` / ``from_checkpoint``).  A fresh
model draws its weights from a seeded ``torch.Generator``; a checkpoint is
the JAX package's npz, carried over by ``from_jax.from_jax_variables``.
Tracking models (any ``Tcaf`` head meta, or a ``t``-prefixed basenet such
as ``tshufflenetv2k16``) get a ``TrackingShell`` over frame pairs, as
``factory.py:128-163`` builds them; the paired TCAF head takes both
frames' features, ``2 * out_features`` channels (flax infers that width).
``norm`` is the backbone's normalization (``--basenet-norm``,
``factory.py:83-85``); a checkpoint does not record it, so loading one
that was trained with another norm needs the same ``norm`` again.

The head options of ``factory.py:75-102`` (``network_cli``):
``head_dropout`` (dropout before each head's conv in train mode),
``cross_talk`` (the train-mode batch mix of ``Shell``; a tracking shell
takes none, as in JAX) and ``upsample_stride`` (each head meta's
PixelShuffle factor raised to at least this).  A checkpoint whose heads
differ from the requested ``head_metas`` is grafted onto them by
``transfer`` (``factory.py:194-262``): a tracking model warm-started from
a single-frame checkpoint, for example.
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Sequence

import torch
from torch import nn

from . import checkpoint as checkpoint_mod
# register the backbones
from . import shufflenetv2k  # noqa: F401  pylint: disable=unused-import
from . import resnet  # noqa: F401  pylint: disable=unused-import
from . import mobilenet  # noqa: F401  pylint: disable=unused-import
from . import squeezenet  # noqa: F401  pylint: disable=unused-import
from . import effnetv2  # noqa: F401  pylint: disable=unused-import
from . import swin  # noqa: F401  pylint: disable=unused-import
from . import xcit  # noqa: F401  pylint: disable=unused-import
from . import botnet  # noqa: F401  pylint: disable=unused-import
from . import hrformer  # noqa: F401  pylint: disable=unused-import
from .base import BASE_FACTORIES, NORM_KINDS, RAW_PARAMETERS
from .from_jax import from_jax_variables
from .heads import CompositeField4
from .shell import Model, Shell
from .tracking_base import TrackingModel, TrackingShell, is_tracking_metas
from .. import headmeta as headmeta_mod
from ..device import resolve_device

LOG = logging.getLogger(__name__)


def build_shell(basenet_name: str, head_metas: Sequence[headmeta_mod.Base],
                norm: str = 'batchnorm', *, head_dropout: float = 0.0,
                cross_talk: float = 0.0, upsample_stride: int = 1):
    """Construct the (uninitialized) Shell, a ``TrackingShell`` for a
    tracking model; returns (shell, base stride)."""
    if norm not in NORM_KINDS:
        raise ValueError(f'unknown norm kind {norm!r}')
    tracking = is_tracking_metas(head_metas)
    if (basenet_name not in BASE_FACTORIES and basenet_name.startswith('t')
            and basenet_name[1:] in BASE_FACTORIES):
        basenet_name, tracking = basenet_name[1:], True
    spec = BASE_FACTORIES[basenet_name]
    for meta in head_metas:
        meta.base_stride = spec.stride
        meta.upsample_stride = max(meta.upsample_stride, upsample_stride)
    paired = [isinstance(m, headmeta_mod.Tcaf) for m in head_metas]
    heads = [CompositeField4(meta, (2 if p else 1) * spec.out_features,
                             dropout_rate=head_dropout)
             for meta, p in zip(head_metas, paired)]
    basenet = spec.build(norm=norm)
    if tracking:
        return TrackingShell(basenet, heads, paired), spec.stride
    return Shell(basenet, heads, cross_talk=cross_talk), spec.stride


def norm_cli(group) -> None:
    """``--basenet-norm``, as ``openpifpaf_tpu/models/factory.py:83-85``
    offers it."""
    group.add_argument('--basenet-norm', default='batchnorm',
                       choices=('batchnorm', 'instancenorm', 'groupnorm'),
                       help='normalization layer in the backbone')


def network_cli(group) -> None:
    """The head options of ``openpifpaf_tpu/models/factory.py:81-92``,
    with its defaults and help."""
    group.add_argument('--head-dropout', default=0.0, type=float,
                       help='[train] dropout before head convs')
    group.add_argument('--head-upsample-stride', default=1, type=int,
                       help='PixelShuffle factor in heads')
    group.add_argument('--cross-talk', default=0.0, type=float,
                       help='[train] cross-talk batch augmentation factor')


def network_options(args) -> dict:
    """``network_cli``'s flags as ``factory`` keywords."""
    return dict(head_dropout=args.head_dropout, cross_talk=args.cross_talk,
                upsample_stride=args.head_upsample_stride)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator``, flax's defaults in kind:
    lecun-normal conv and Dense kernels (variance 1/fan_in), zero biases,
    identity BatchNorm (scale 1, bias 0, mean 0, var 1), LayerNorm and
    GroupNorm scale 1 and bias 0, and the raw parameters of
    ``base.RAW_PARAMETERS`` by their initializers (Swin's bias table a
    normal of std 0.02 truncated at 2 std, BoTNet's embeddings a normal of
    std 0.02, XCiT's temperature and layer scales 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
    for name, p in module.named_parameters():
        kind = RAW_PARAMETERS.get(name.rsplit('.', 1)[-1])
        if kind == 'ones':
            p.fill_(1.0)
        elif kind == 'normal_0.02':
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif kind == 'truncated_normal_0.02':
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)


def _model(shell, head_metas, stride: int, basenet_name: str, device,
           bf16: bool) -> Model:
    model_cls = TrackingModel if isinstance(shell, TrackingShell) else Model
    return model_cls(shell, head_metas, base_stride=stride,
                     basenet_name=basenet_name, device=device, bf16=bf16)


def _heads_match(loaded: Sequence[headmeta_mod.Base],
                 wanted: Sequence[headmeta_mod.Base]) -> bool:
    """The same heads in the same order, by type, dataset and name
    (``factory.py:188-192``)."""
    def ids(metas):
        return [(type(m).__name__, m.dataset, m.name) for m in metas]
    return ids(loaded) == ids(wanted)


def _group(state) -> dict:
    """A Shell's state dict by top-level module: ``basenet`` and
    ``head_nets.<i>``."""
    groups = {}
    for key, value in state.items():
        parts = key.split('.')
        module = '.'.join(parts[:2]) if parts[0] == 'head_nets' else parts[0]
        groups.setdefault(module, {})[key] = value
    return groups


def transfer(loaded: Model, head_metas: Sequence[headmeta_mod.Base], *,
             seed: int = 0, norm: str = 'batchnorm', **network) -> Model:
    """Graft a loaded model's weights onto a model with ``head_metas``
    (``openpifpaf_tpu/models/factory.py:194-262``).

    The backbone transfers; a head transfers from the checkpoint head of
    the same (dataset, name) or, failing that, from the first of the same
    name (a warning names an ambiguous name), in both cases only when
    every parameter and statistic has the same shape.  Everything else
    keeps the fresh weights drawn from ``torch.Generator().manual_seed(seed)``.
    The epoch starts at 0.  One log line names what transferred and what
    is fresh, a warning when anything is.  ``network``: ``build_shell``'s
    head options."""
    shell, stride = build_shell(loaded.basenet_name, head_metas, norm,
                                **network)
    init_weights(shell, torch.Generator().manual_seed(seed))
    old = _group(loaded.module.state_dict())
    exact, by_name, counts = {}, {}, {}
    for j, m in enumerate(loaded.head_metas):
        exact.setdefault((m.dataset, m.name), f'head_nets.{j}')
        by_name.setdefault(m.name, f'head_nets.{j}')
        counts[m.name] = counts.get(m.name, 0) + 1

    def shapes(group, prefix):
        return {k[len(prefix):]: tuple(v.shape) for k, v in group.items()}

    state = shell.state_dict()
    transferred, fresh = [], []
    for module, group in _group(state).items():
        meta = None
        src = module if module in old else None
        if module.startswith('head_nets.'):
            meta = head_metas[int(module.split('.')[1])]
            src = exact.get((meta.dataset, meta.name))
            if src is None:
                src = by_name.get(meta.name)
                if src is not None and counts[meta.name] > 1:
                    LOG.warning('head %r matches several checkpoint heads; '
                                'transferring the first (%s)', meta.name,
                                src.replace('.', '_'))
        # the JAX package's names (head_nets_<i> (<name>)): the log reads
        # as JAX's
        label = module if meta is None else \
            f'{module.replace(".", "_")} ({meta.name})'
        if src is not None and shapes(old[src], src) == \
                shapes(group, module):
            for key in group:
                state[key] = old[src][src + key[len(module):]]
            transferred.append(label)
        else:
            fresh.append(label)
    shell.load_state_dict(state, strict=True)
    log = LOG.warning if fresh else LOG.info
    log('transfer learning: %s from checkpoint; FRESH (random) weights: %s',
        transferred, fresh)
    return _model(shell, head_metas, stride, loaded.basenet_name,
                  loaded.device, loaded.bf16)


def factory(base_name: Optional[str] = None,
            head_metas: Optional[Sequence[headmeta_mod.Base]] = None, *,
            checkpoint: Optional[str] = None, bf16: bool = True,
            device=None, seed: int = 0, norm: str = 'batchnorm',
            **network) -> Model:
    """Build a Model on ``device`` (``None``: the card, raising without
    CUDA).  ``checkpoint`` (an npz of the JAX package's format) wins over
    ``base_name``; its heads are grafted onto ``head_metas`` by
    ``transfer`` where they differ.  A fresh model draws its weights from
    ``torch.Generator().manual_seed(seed)``.  ``network``: the head
    options of ``build_shell`` (``network_options``).
    """
    device = resolve_device(device)
    if checkpoint is None:
        if not base_name or head_metas is None:
            raise ValueError('either checkpoint or base_name and head_metas '
                             'must be given')
        shell, stride = build_shell(base_name, head_metas, norm, **network)
        init_weights(shell, torch.Generator().manual_seed(seed))
        return _model(shell, head_metas, stride, base_name, device, bf16)
    header, flat = checkpoint_mod.load(checkpoint)
    shell, stride = build_shell(header['basenet'], header['head_metas'], norm,
                                **network)
    shell.load_state_dict(from_jax_variables(flat), strict=True)
    model = _model(shell, header['head_metas'], stride, header['basenet'],
                   device, bf16)
    model.epoch = header.get('epoch', 0)
    LOG.info('loaded checkpoint %s (epoch %d)', checkpoint, model.epoch)
    if head_metas is not None and not _heads_match(model.head_metas,
                                                   head_metas):
        model = transfer(model, head_metas, seed=seed, norm=norm, **network)
    return model
