"""Upstream openpifpaf torch state dicts, both ways.

Port of ``openpifpaf_tpu/models/converter.py``: the name tables of the
ShuffleNetV2K, ResNet, Swin (microsoft naming) and XCiT (facebookresearch
naming) trunks (``:51``, ``:90``, ``:132``, ``:186``) and of the heads
(``head_nets.N.conv.*``), with the same layout rules:

- conv kernels: torch OIHW <-> HWIO (a depthwise ``(C, 1, kh, kw)`` <->
  ``(kh, kw, 1, C)``)
- linear kernels: torch ``(out, in)`` <-> Dense ``(in, out)``
- batch norm: ``weight``/``bias`` <-> ``scale``/``bias`` params, the
  running statistics <-> ``batch_stats``
- layer norm: ``weight``/``bias`` <-> ``scale``/``bias``

``convert_state_dict`` gives the flat ``collection/path`` arrays that the
npz checkpoints store (``checkpoint.save``), which ``from_jax`` turns into
the port's modules; ``to_torch_state_dict`` is the way back, and raises on
a variable it cannot name.  ``load_torch_checkpoint`` reads a file that
``torch.save`` wrote: a state dict, a whole module or ``{'model': ...}``.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Tuple

import numpy as np

LOG = logging.getLogger(__name__)


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO, which takes a depthwise (C, 1, kh, kw) to
    (kh, kw, 1, C)."""
    if w.ndim != 4:
        raise ValueError(f'not a conv kernel: shape {w.shape}')
    return w.transpose(2, 3, 1, 0)


def _conv_to_torch(w: np.ndarray) -> np.ndarray:
    return w.transpose(3, 2, 0, 1)


# ----------------------------------------------------------------------
# name translation: torch module path -> (collection, flax path), the
# tables of openpifpaf_tpu/models/converter.py:51-230
def _translate_shufflenet(key: str) -> Tuple[str, str]:
    """'conv1.0.weight' etc. (basenet-relative) -> flax path."""
    m = re.match(r'conv([15])\.(\d)\.(\w+)$', key)
    if m:
        conv_i, seq_i, leaf = m.groups()
        if seq_i == '0':
            # conv slot of the Sequential: only a kernel lives here.  A
            # wildcard here would let to_torch_state_dict's candidate probe
            # name conv kernels e.g. 'conv1.0.running_var' (caught by the
            # independent-torch cross-validation, tests/test_torch_crossval).
            if leaf != 'weight':
                raise KeyError(key)
            return 'params', f'conv{conv_i}/kernel'
        return _bn_leaf(f'conv{conv_i}_norm', leaf)
    m = re.match(r'stage(\d)\.(\d+)\.branch(\d)\.(\d)\.(\w+)$', key)
    if m:
        stage, block, branch, seq_i, leaf = m.groups()
        prefix = f'stage{stage}_{block}'
        if branch == '1':
            names = {'0': ('conv', 'branch1_dwconv'),
                     '1': ('bn', 'branch1_dwnorm'),
                     '2': ('conv', 'branch1_conv'),
                     '3': ('bn', 'branch1_norm')}
        else:
            names = {'0': ('conv', 'branch2_conv1'),
                     '1': ('bn', 'branch2_norm1'),
                     '3': ('conv', 'branch2_dwconv'),
                     '4': ('bn', 'branch2_dwnorm'),
                     '5': ('conv', 'branch2_conv2'),
                     '6': ('bn', 'branch2_norm2')}
        kind, name = names[seq_i]
        if kind == 'conv':
            if leaf != 'weight':
                raise KeyError(key)
            return 'params', f'{prefix}/{name}/kernel'
        return _bn_leaf(f'{prefix}/{name}', leaf)
    raise KeyError(key)


def _translate_resnet(key: str) -> Tuple[str, str]:
    m = re.match(r'conv1\.(\w+)$', key)
    if m:
        return 'params', 'conv1/kernel'
    m = re.match(r'bn1\.(\w+)$', key)
    if m:
        return _bn_leaf('bn1', m.group(1))
    m = re.match(r'layer(\d)\.(\d+)\.conv(\d)\.weight$', key)
    if m:
        return 'params', f'layer{m.group(1)}_{m.group(2)}/conv{m.group(3)}/kernel'
    m = re.match(r'layer(\d)\.(\d+)\.bn(\d)\.(\w+)$', key)
    if m:
        return _bn_leaf(f'layer{m.group(1)}_{m.group(2)}/bn{m.group(3)}',
                        m.group(4))
    m = re.match(r'layer(\d)\.(\d+)\.downsample\.0\.weight$', key)
    if m:
        return 'params', f'layer{m.group(1)}_{m.group(2)}/downsample_conv/kernel'
    m = re.match(r'layer(\d)\.(\d+)\.downsample\.1\.(\w+)$', key)
    if m:
        return _bn_leaf(f'layer{m.group(1)}_{m.group(2)}/downsample_bn',
                        m.group(3))
    raise KeyError(key)


def _bn_leaf(flax_prefix: str, torch_leaf: str) -> Tuple[str, str]:
    mapping = {
        'weight': ('params', 'scale'),
        'bias': ('params', 'bias'),
        'running_mean': ('batch_stats', 'mean'),
        'running_var': ('batch_stats', 'var'),
    }
    if torch_leaf == 'num_batches_tracked':
        return 'skip', ''
    coll, leaf = mapping[torch_leaf]
    return coll, f'{flax_prefix}/{leaf}'


def _ln_leaf(flax_prefix: str, torch_leaf: str) -> Tuple[str, str]:
    mapping = {'weight': 'scale', 'bias': 'bias'}
    return 'params', f'{flax_prefix}/{mapping[torch_leaf]}'


def _translate_swin(key: str) -> Tuple[str, str]:
    """Microsoft-Swin state-dict naming -> the flax ``models/swin.py`` tree.

    Reference surface: ``src/openpifpaf/network/basenetworks.py:~650``
    (the reference vendors the microsoft Swin implementation; its
    checkpoints use ``layers.S.blocks.B.attn.qkv.weight`` etc.).  The
    stride-16 dense-prediction adaptation replaces the final patch
    merging with a channel projection (``layers.2.proj.weight`` here,
    ``merge3_proj`` in flax): that one tensor has no counterpart in
    upstream's zoo; the JAX package's ``tools/torch_models.py::Swin``
    writes it.
    """
    m = re.match(r'patch_embed\.proj\.(weight|bias)$', key)
    if m:
        leaf = 'kernel' if m.group(1) == 'weight' else 'bias'
        return 'params', f'patch_embed/{leaf}'
    m = re.match(r'patch_embed\.norm\.(\w+)$', key)
    if m:
        return _ln_leaf('patch_norm', m.group(1))
    m = re.match(r'norm\.(\w+)$', key)
    if m:
        return _ln_leaf('norm_out', m.group(1))
    m = re.match(r'layers\.(\d)\.downsample\.norm\.(\w+)$', key)
    if m:
        return _ln_leaf(f'merge{int(m.group(1)) + 1}/norm', m.group(2))
    m = re.match(r'layers\.(\d)\.downsample\.reduction\.weight$', key)
    if m:
        return 'params', f'merge{int(m.group(1)) + 1}/reduction/kernel'
    m = re.match(r'layers\.2\.proj\.weight$', key)
    if m:
        return 'params', 'merge3_proj/kernel'
    m = re.match(r'layers\.(\d)\.blocks\.(\d+)\.(.*)$', key)
    if m:
        stage, block, rest = m.groups()
        prefix = f'stage{stage}_block{block}'
        mm = re.match(r'norm([12])\.(\w+)$', rest)
        if mm:
            return _ln_leaf(f'{prefix}/norm{mm.group(1)}', mm.group(2))
        mm = re.match(r'attn\.(qkv|proj)\.(weight|bias)$', rest)
        if mm:
            leaf = 'kernel' if mm.group(2) == 'weight' else 'bias'
            return 'params', f'{prefix}/attn/{mm.group(1)}/{leaf}'
        if rest == 'attn.relative_position_bias_table':
            return 'params', f'{prefix}/attn/relative_position_bias_table'
        if rest in ('attn.relative_position_index', 'attn_mask'):
            return 'skip', ''
        mm = re.match(r'mlp\.fc([12])\.(weight|bias)$', rest)
        if mm:
            fc, wb = mm.group(1), mm.group(2)
            leaf = 'kernel' if wb == 'weight' else 'bias'
            return 'params', f'{prefix}/mlp_fc{fc}/{leaf}'
    raise KeyError(key)


def _translate_xcit(key: str) -> Tuple[str, str]:
    """facebookresearch-XCiT state-dict naming -> the flax
    ``models/xcit.py`` tree.

    Reference surface: ``src/openpifpaf/network/basenetworks.py:~750``
    (the reference vendors the facebookresearch XCiT implementation in
    ``network/xcit.py``; checkpoints use ``patch_embed.proj.0.0.weight``,
    ``pos_embeder.token_projection.weight``, ``blocks.N.attn.qkv.weight``
    etc.).  The classification tail (``cls_token``/``cls_attn_blocks``/
    ``head``) has no dense-prediction counterpart and is skipped.  The
    timm re-export of the same checkpoints renames ``pos_embeder`` to
    ``pos_embed``; both spellings are accepted.
    """
    m = re.match(r'patch_embed\.proj\.([0246])\.([01])\.(\w+)$', key)
    if m:
        i = int(m.group(1)) // 2
        if m.group(2) == '0':
            if m.group(3) != 'weight':
                raise KeyError(key)
            return 'params', f'stem/conv{i}/kernel'
        return _bn_leaf(f'stem/norm{i}', m.group(3))
    m = re.match(r'pos_embed(?:er)?\.token_projection\.(weight|bias)$', key)
    if m:
        leaf = 'kernel' if m.group(1) == 'weight' else 'bias'
        return 'params', f'pos_embed/token_projection/{leaf}'
    m = re.match(r'norm\.(\w+)$', key)
    if m:
        return _ln_leaf('norm_out', m.group(1))
    if re.match(r'(cls_token|cls_attn_blocks\.|head\.|head_dist\.)', key):
        # classification-only modules: dropped for dense prediction
        return 'skip', ''
    m = re.match(r'blocks\.(\d+)\.(.*)$', key)
    if m:
        prefix = f'block{m.group(1)}'
        rest = m.group(2)
        mm = re.match(r'norm([123])\.(\w+)$', rest)
        if mm:
            return _ln_leaf(f'{prefix}/norm{mm.group(1)}', mm.group(2))
        if rest == 'attn.temperature':
            return 'params', f'{prefix}/xca/temperature'
        mm = re.match(r'attn\.(qkv|proj)\.(weight|bias)$', rest)
        if mm:
            leaf = 'kernel' if mm.group(2) == 'weight' else 'bias'
            return 'params', f'{prefix}/xca/{mm.group(1)}/{leaf}'
        mm = re.match(r'gamma([123])$', rest)
        if mm:
            return 'params', f'{prefix}/gamma{mm.group(1)}'
        mm = re.match(r'local_mp\.conv([12])\.(weight|bias)$', rest)
        if mm:
            leaf = 'kernel' if mm.group(2) == 'weight' else 'bias'
            return 'params', f'{prefix}/lpi_conv{mm.group(1)}/{leaf}'
        mm = re.match(r'local_mp\.bn\.(\w+)$', rest)
        if mm:
            return _bn_leaf(f'{prefix}/lpi_bn', mm.group(1))
        mm = re.match(r'mlp\.fc([12])\.(weight|bias)$', rest)
        if mm:
            leaf = 'kernel' if mm.group(2) == 'weight' else 'bias'
            return 'params', f'{prefix}/mlp_fc{mm.group(1)}/{leaf}'
    raise KeyError(key)


_BASENET_TRANSLATORS = {
    'shufflenetv2k': _translate_shufflenet,
    'resnet': _translate_resnet,
    'swin': _translate_swin,
    'xcit': _translate_xcit,
}


def _translator_for(basenet_name: str):
    for prefix, fn in _BASENET_TRANSLATORS.items():
        if basenet_name.startswith(prefix):
            return fn
    raise ValueError(f'no torch converter for basenet {basenet_name!r}; '
                     f'supported: {sorted(_BASENET_TRANSLATORS)}')


def convert_state_dict(state_dict: Dict[str, np.ndarray],
                       *, basenet_name: str) -> Dict[str, np.ndarray]:
    """Torch state dict -> flat ``collection/path`` variables.

    :param state_dict: name -> array, upstream naming (``base_net.*``,
        ``head_nets.N.conv.*``; ``module.`` prefixes of DataParallel are
        stripped).  Heads map by index: upstream's ``head_nets.N`` is
        ``head_nets_N``.
    """
    translate = _translator_for(basenet_name)
    flat: Dict[str, np.ndarray] = {}
    skipped = []
    for key, value in state_dict.items():
        value = np.asarray(value)
        key = key.removeprefix('module.')
        if key.startswith('base_net.'):
            coll, path = translate(key[len('base_net.'):])
            if coll == 'skip':
                continue
            if path.endswith('/kernel'):
                # conv OIHW -> HWIO; Linear (out, in) -> Dense (in, out)
                value = (_conv_to_flax(value) if value.ndim == 4
                         else value.T)
            flat[f'{coll}/basenet/{path}'] = value
        elif key.startswith('head_nets.'):
            m = re.match(r'head_nets\.(\d+)\.conv\.(weight|bias)$', key)
            if not m:
                skipped.append(key)
                continue
            head = f'head_nets_{m.group(1)}'
            if m.group(2) == 'weight':
                flat[f'params/{head}/conv/kernel'] = _conv_to_flax(value)
            else:
                flat[f'params/{head}/conv/bias'] = value
        else:
            skipped.append(key)
    if skipped:
        LOG.warning('skipped %d unrecognized keys (e.g. %s)', len(skipped),
                    skipped[:5])
    return flat


def to_torch_state_dict(flat: Dict[str, np.ndarray], *,
                        basenet_name: str) -> Dict[str, np.ndarray]:
    """Flat ``collection/path`` variables -> upstream torch naming."""
    translate = _translator_for(basenet_name)
    # flax path -> torch name, from the forward tables by probing
    forward: Dict[str, str] = {}
    for torch_key in _enumerate_torch_keys(flat, translate):
        coll, path = translate(torch_key.removeprefix('base_net.'))
        forward[f'{coll}/basenet/{path}'] = torch_key

    out: Dict[str, np.ndarray] = {}
    unmapped = []
    for path, value in flat.items():
        value = np.asarray(value)
        if path in forward:
            if path.endswith('/kernel'):
                value = (_conv_to_torch(value) if value.ndim == 4
                         else value.T)
            out[forward[path]] = value
            continue
        m = re.match(r'params/head_nets_(\d+)/conv/(kernel|bias)$', path)
        if m:
            head = f'head_nets.{m.group(1)}.conv'
            if m.group(2) == 'kernel':
                out[f'{head}.weight'] = _conv_to_torch(value)
            else:
                out[f'{head}.bias'] = value
            continue
        unmapped.append(path)
    if unmapped:
        # a silent drop would corrupt every comparison built on the file
        raise ValueError(
            f'{len(unmapped)} variables have no torch mapping (candidate '
            f'grid in _enumerate_torch_keys too small, or unsupported '
            f'module): {unmapped[:8]}')
    return out


def _enumerate_torch_keys(flat, translate):
    """Generate candidate torch keys whose translation lands in ``flat``.

    Exhaustive candidate generation over a generous grid is simpler than
    inverting the translation regexes.
    """
    candidates = []
    for conv_i in (1, 5):
        for seq_i in (0, 1):
            for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
                candidates.append(f'base_net.conv{conv_i}.{seq_i}.{leaf}')
    for stage in range(2, 5):
        for block in range(32):
            for branch, seq_is in ((1, (0, 1, 2, 3)), (2, (0, 1, 3, 4, 5, 6))):
                for seq_i in seq_is:
                    for leaf in ('weight', 'bias', 'running_mean',
                                 'running_var'):
                        candidates.append(
                            f'base_net.stage{stage}.{block}.branch{branch}'
                            f'.{seq_i}.{leaf}')
    candidates.append('base_net.conv1.weight')
    for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
        candidates.append(f'base_net.bn1.{leaf}')
    for layer in range(1, 5):
        for block in range(40):
            for conv_i in (1, 2, 3):
                candidates.append(
                    f'base_net.layer{layer}.{block}.conv{conv_i}.weight')
                for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
                    candidates.append(
                        f'base_net.layer{layer}.{block}.bn{conv_i}.{leaf}')
            candidates.append(
                f'base_net.layer{layer}.{block}.downsample.0.weight')
            for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
                candidates.append(
                    f'base_net.layer{layer}.{block}.downsample.1.{leaf}')

    # swin (microsoft naming; generous grid over stages/blocks)
    for leaf in ('weight', 'bias'):
        candidates.append(f'base_net.patch_embed.proj.{leaf}')
        candidates.append(f'base_net.patch_embed.norm.{leaf}')
        candidates.append(f'base_net.norm.{leaf}')
    for stage in range(4):
        for leaf in ('weight', 'bias'):
            candidates.append(f'base_net.layers.{stage}.downsample.norm.{leaf}')
        candidates.append(f'base_net.layers.{stage}.downsample.reduction.weight')
        for block in range(24):
            base = f'base_net.layers.{stage}.blocks.{block}'
            for mod in ('norm1', 'norm2', 'attn.qkv', 'attn.proj',
                        'mlp.fc1', 'mlp.fc2'):
                for leaf in ('weight', 'bias'):
                    candidates.append(f'{base}.{mod}.{leaf}')
            candidates.append(f'{base}.attn.relative_position_bias_table')
    candidates.append('base_net.layers.2.proj.weight')

    # xcit (facebookresearch naming)
    for i in (0, 2, 4, 6):
        candidates.append(f'base_net.patch_embed.proj.{i}.0.weight')
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            candidates.append(f'base_net.patch_embed.proj.{i}.1.{leaf}')
    for leaf in ('weight', 'bias'):
        candidates.append(f'base_net.pos_embeder.token_projection.{leaf}')
    for block in range(36):
        base = f'base_net.blocks.{block}'
        candidates.append(f'{base}.attn.temperature')
        for n in (1, 2, 3):
            candidates.append(f'{base}.gamma{n}')
            for leaf in ('weight', 'bias'):
                candidates.append(f'{base}.norm{n}.{leaf}')
        for mod in ('attn.qkv', 'attn.proj', 'local_mp.conv1',
                    'local_mp.conv2', 'mlp.fc1', 'mlp.fc2'):
            for leaf in ('weight', 'bias'):
                candidates.append(f'{base}.{mod}.{leaf}')
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            candidates.append(f'{base}.local_mp.bn.{leaf}')

    out = []
    for cand in candidates:
        try:
            coll, path = translate(cand.removeprefix('base_net.'))
        except (KeyError, ValueError):
            continue
        if coll != 'skip' and f'{coll}/basenet/{path}' in flat:
            out.append(cand)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A file of ``torch.save``: a state dict, a whole pickled module, or
    a dict holding either under ``'model'``; as numpy arrays.  It unpickles
    (``weights_only=False``, as the JAX package does): load only files
    you trust."""
    import torch  # pylint: disable=import-outside-toplevel

    data = torch.load(path, map_location='cpu', weights_only=False)
    if hasattr(data, 'state_dict'):           # a whole pickled module
        data = data.state_dict()
    elif isinstance(data, dict) and 'model' in data:
        model = data['model']
        data = model.state_dict() if hasattr(model, 'state_dict') else model
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, 'detach')
                          else v) for k, v in data.items()}
