"""JAX variables -> the port's ``state_dict``, and mmdet checkpoints -> the
port's model.

``load_mmdet_checkpoint`` grafts the tensors of an mmdet-layout checkpoint
(``state_dict``, ``meta``, ``optimizer``; a published OA-DG or mmdet
``.pth``) onto a built model, as ``load_checkpoint_variables`` and
``merge_variables`` of ``oadg_tpu/utils/checkpoint.py`` (``:296-326``,
``:136``) do: ``num_batches_tracked`` and mmdet's EMA buffers (``ema_*``)
are skipped, a classification checkpoint (no key under a detector section)
is read as the backbone's (the rest of the model keeps its values), and
keys the model lacks are skipped; each is reported. A detector checkpoint
that lacks one of the model's tensors, or a tensor whose shape differs
from the model's, raises (the JAX package keeps its own values in both
cases; ROADMAP C); so does one that holds a tensor of a structure the JAX
heads lack (``MMDET_ONLY``: mmdet's ``DynamicConv.fc_norm`` of Sparse R-CNN's
stages, its ``GridHead`` fusion ``forder_trans`` / ``sorder_trans``,
VFNet's ``vfnet_reg_conv``, the ATSS parts of mmdet's PAA head, the NAS
necks' extra-level convs and mmdet's NAS-FPN ``sum_77_7`` / ``gp_54_7``
and cell conv biases, NAS-FCOS's concat cells and deformable tower convs,
the ``conv2`` after mmdet's ``BiCornerPool``, CentripetalNet's guiding
shifts and feature adaption, a downsample in a later block of an
Hourglass ``low3``, YOLACT's separate protonet and semantic head,
SSD's ``SSDNeck``, DETR's decoder ``post_norm``, ChannelMapper's extra
level and GNs, and mmdet's PanopticFPNHead), which skipping would silently
change. A CSPDarknet's
Focus stem conv has its input blocks reordered from mmdet's (dy, dx) order
to the JAX package's (``csp_darknet.focus_mmdet_order``).

``jax_variables_to_state_dict`` is the exact inverse of
``oadg_tpu/utils/checkpoint.py:convert_torch_state_dict`` (``:37``): HWIO conv
kernels become OIHW, ``(in, out)`` dense kernels become ``(out, in)``, and the
first shared FC's input is reordered from the JAX package's HWC flattening of
the RoI features back to mmdet's CHW (``:102-108``), with the RoI channel
count of the model: the FC's input width over ``roi_feat_size ** 2`` (256 on
the flagship, 2048 on the DWD R101-DC5), checked against ``roi_channels``
where the caller gives it. Frozen-BN ``scale`` /
``bias`` / ``mean`` / ``var`` become ``weight`` / ``bias`` / ``running_mean``
/ ``running_var``; so do those of the live and frozen BNs of the YOLOv3
config's ``ConvModule``s (``<scope>/conv/Conv_0/kernel`` and
``<scope>/FrozenBN_0/*`` become ``<module>.conv.weight`` and
``<module>.bn.*``): the Darknet's ``conv1``, ``down{i}`` and
``stage{i}_{j}/conv{k}`` (``conv_res_block{i}.conv``,
``conv_res_block{i}.res{j}.conv{k}``), the YOLO neck's ``detect{i}/conv{k}``
and ``conv{i}``, the YOLO head's ``conv_bridge{i}``, ``conv_cont{i}`` and
``conv_pred{i}`` (``bbox_head.convs_bridge.{i}``, ``.convs_cont.{i}``,
``.convs_pred.{i}``). RetinaNet's head ``cls_conv{i}`` / ``reg_conv{i}``
(``<scope>/Conv_0/*``), ``retina_cls`` and ``retina_reg`` become
``bbox_head.cls_convs.{i}.conv``, ``.reg_convs.{i}.conv``, ``.retina_cls``
and ``.retina_reg``; the FPN's ``extra_conv_k`` becomes ``neck.fpn_convs.{L +
k}`` after its L laterals; the C4 shared head ``roi/shared_head_m/layer4_j``
becomes ``roi_head.shared_head.layer4.j`` (a backbone block's names); a
ResNeXt block's grouped ``conv2/kernel`` and a DCNv2 block's ``conv2/kernel``
and ``conv2/conv_offset/Conv_0/*`` become ``conv2.weight`` and
``conv2.conv_offset.{weight,bias}``. Mask R-CNN's mask head ``roi/mask_head_m``:
``conv_{i}``, ``upsample`` and ``conv_logits`` become
``roi_head.mask_head.convs.{i}.conv``, ``.upsample`` and ``.conv_logits``;
the transposed conv's flax kernel ``(kh, kw, in, out)`` becomes torch's
``(in, out, kh, kw)`` flipped in both spatial axes (flax's
``ConvTranspose`` is a stride-2 convolution of the dilated input with the
kernel as given; torch's ``conv_transpose2d`` scatters each input through
the kernel, which is the same convolution with the kernel flipped). The
two-stage family: a cascade's ``roi/heads_{k}`` becomes
``roi_head.bbox_head.{k}`` (its first FC reordered too), HTC's
``mask_heads_{k}`` ``roi_head.mask_head.{k}`` (flipped likewise),
``info_conv{k}`` ``roi_head.info_convs.{k}``, ``semantic`` (``lateral{i}``,
``conv{i}``, ``conv_embedding``, ``conv_seg``)
``roi_head.semantic_head.{lateral_convs.{i}.conv, convs.{i}.conv,
conv_embedding.conv, conv_logits}``, SCNet's ``glbctx`` (``conv{i}``,
``fc``) ``roi_head.glbctx_head.{convs.{i}.conv, fc}``, MS R-CNN's
``maskiou`` (``conv{i}``, ``fc{i}``, ``iou_pred``)
``roi_head.mask_iou_head.{convs.{i}, fcs.{i}, fc_mask_iou}`` (``fcs.0``
reordered from HWC to CHW at the last conv's width), and the Double-Head's
``conv_in``, ``res{i}_conv{j}`` and ``fc{i}``
``roi_head.bbox_head.{conv_in, conv_branch.{i}.conv{j}, fc_branch.{i}}``
(``fc_branch.0`` reordered as ``shared_fcs.0``). The rest of the
two-stage family: Sparse R-CNN's ``rpn/init_proposal_{bboxes,features}``
become ``rpn_head.init_proposal_{bboxes,features}.weight`` and its stages
``roi/dii{k}`` ``roi_head.bbox_head.{k}`` (``self_attn``'s ``query``,
``key`` and ``value`` kernels (E, heads, head_dim) stacked into
``attention.attn.in_proj_weight`` (3E, E), their biases into
``in_proj_bias``, ``out`` into ``attention.attn.out_proj``; ``norm1``
``attention_norm``, ``dynamic_gen`` / ``dn1`` / ``dn2`` / ``out_proj``
``instance_interactive_conv.{dynamic_layer, norm_in, norm_out, fc_layer}``,
``norm2`` ``instance_interactive_conv_norm``, ``ffn1`` / ``ffn2``
``ffn.layers.0.0`` / ``ffn.layers.1``, ``norm3`` ``ffn_norm``,
``cls_fc{i}`` / ``cls_ln{i}`` ``cls_fcs.{3i}`` / ``cls_fcs.{3i + 1}`` and
the same for ``reg``; a LayerNorm's or GroupNorm's ``scale`` is its
``weight``); Grid R-CNN's ``roi/grid`` (``conv{i}``, ``gn{i}``,
``deconv1``, ``deconv2``) ``roi_head.grid_head.{convs.{i}.conv,
convs.{i}.gn, deconv1, deconv2}`` (the deconvs flipped as ``upsample``);
PointRend's ``roi/point`` (``fc{i}``, ``fc_logits``)
``roi_head.point_head.{fcs.{i}.conv, fc_logits}`` as (out, in, 1)
``Conv1d`` weights; a TridentResNet's shared ``layer4_{j}/conv2_kernel``
``backbone.layer4.{j}.conv2.weight`` and its block's fourth BN
(``FrozenBN_3``) ``downsample.1``. The one-stage family's heads (under
``bbox_head``): ``cls_conv{i}`` / ``cls_gn{i}`` (and ``reg_``, TOOD's
``inter_``) become ``cls_convs.{i}.conv`` / ``.gn``; a per-level
``scales`` (ATSS's and GFL's ``reg_scales``, VFNet's ``scales_refine``)
vector becomes one ``scales.{i}.scale`` scalar a level; ``conv_ctr``
``conv_centerness``; VFNet's ``reg_refine_dconv`` / ``cls_dconv`` (DCN
kernels) and their GNs ``reg_refine_gn`` / ``cls_gn``
``vfnet_reg_refine_dconv`` / ``vfnet_cls_dconv`` / ``vfnet_reg_refine_gn``
/ ``vfnet_cls_gn``; TOOD's ``{cls,reg}_decomp`` ``la_conv1`` / ``la_conv2``
/ ``reduction_conv`` / ``gn`` ``layer_attention.0`` / ``.2`` /
``reduction_conv.conv`` / ``reduction_conv.gn``, ``cls_prob_conv{1,2}``
and ``reg_offset_conv{1,2}`` ``cls_prob_module.{0,2}`` and
``reg_offset_module.{0,2}``; AutoAssign's ``center_prior_mean`` /
``_sigma`` ``center_prior.mean`` / ``.sigma``; the other convs keep their
names (``atss_cls``, ``gfl_reg``, ``tood_cls``, PAA's ``retina_iou``, ...).
Fovea's and FSAF's towers and outputs keep the same names (``cls_conv{i}``
``cls_convs.{i}.conv``, ``conv_cls``, ``conv_reg``); mmdet's FSAF, a
RetinaHead, names its outputs ``retina_cls`` and ``retina_reg``, which
``load_mmdet_checkpoint`` reads into them (the head's ``mmdet_names``). A
KD detector's ``teacher`` subtree goes under ``teacher_model.`` (mmdet's
``KnowledgeDistillationSingleStageDetector`` attribute).
The NAS necks and heads of A.2.7b: a live-BN ``ConvModule``'s
``conv/Conv_0/kernel`` and ``FrozenBN_0/*`` (its ``batch_stats`` ``mean`` /
``var`` too) become ``conv.weight`` and ``bn.*``; NAS-FPN's ``lateral{i}``
``neck.lateral_convs.{i}`` and its cells ``s{s}_gp64_4`` ... ``neck.fpn_stages.{s}.gp_64_4``
... (``_NAS_CELLS``) with their ``out_conv``; NAS-FCOS's ``lateral{i}``
``neck.adapt_convs.{i}`` and ``merge{i}`` ``neck.merge_convs.{i - 1}``;
NAS-FCOS's head's ``cls_sep{i}`` ``cls_convs.{i}.conv``; RetinaSepBNHead's
``cls_bn{l}_{i}`` ``cls_convs.{l}.{i}.bn`` and its shared ``cls_conv{i}``
``cls_convs.{l}.{i}.conv`` under every level ``l``; GA's ``adapt_cls`` /
``adapt_reg`` (``conv_offset``, the DCN kernel ``conv_adaption``)
``feature_adaption_cls`` / ``_reg``, ``conv_loc`` and ``conv_shape`` as
they are; SABL's ``bucket_cls`` / ``bucket_reg`` ``retina_bbox_cls`` /
``retina_bbox_reg``.
The heads and backbone of A.2.7c: RepPoints' ``cls_dconv``, ``cls_out``,
``pts_init_conv``, ``pts_init_out``, ``pts_refine_dconv`` and
``pts_refine_out`` become ``reppoints_cls_conv``, ``reppoints_cls_out``,
``reppoints_pts_init_conv``, ``reppoints_pts_init_out``,
``reppoints_pts_refine_conv`` and ``reppoints_pts_refine_out`` (its GNs
``cls_gn_out`` / ``pts_refine_gn``, which mmdet lacks, and
``moment_transfer`` keep their names); CenterNet's ``heatmap_conv`` /
``heatmap_out`` (and ``wh_``, ``offset_``) ``heatmap_head.0`` / ``.2``;
the corner heads' ``tl_heat{i}_c1`` / ``_c2`` (and ``br_``, ``_emb``,
``_off``; ``tl_ctr`` as ``tl_centripetal_shift``) ``tl_heat.{i}.0.conv`` /
``.1.conv``, their pools ``tl_pool{i}`` (``conv1``, ``conv2``,
``out_conv``, ``shortcut``) ``tl_pool.{i}.{direction1_conv,
direction2_conv, aftpool_conv, conv1}``; the Hourglass's ``stem_conv``
``backbone.stem.0``, ``stem_res0`` ``stem.1.0``, ``hg{s}`` (``up1_{j}``,
``low1_{j}``, ``low2`` nested or ``low2_{j}``, ``low3_{j}``)
``hourglass_modules.{s}.up1.{j}`` ..., ``out_conv{s}`` ``out_convs.{s}``,
``remap_x{s}`` ``conv1x1s.{s}``, ``remap_f{s}`` ``remap_convs.{s}``,
``inter_res{s}_0`` ``inters.{s}`` (every BN's ``batch_stats`` too).
The modules of A.2.7d: SSDVGG's ``conv{s}_{c}``, ``conv6`` and ``conv7``
become ``backbone.features.{i}`` (mmdet's VGG indices 0 ... 33),
``extra{i}`` ``backbone.extra.{i}`` and ``l2_norm_scale_p``
``backbone.l2_norm.weight``; SSD's head ``cls_conv{i}`` / ``reg_conv{i}``
``bbox_head.cls_convs.{i}`` / ``reg_convs.{i}``; CSPDarknet's ``stem``
``backbone.stem.conv``, ``stage{k}_conv`` / ``_spp`` / ``_csp``
``backbone.stage{k}.0`` / ``.1`` / ``.1`` or ``.2`` (a ``CSPLayer``'s
``block{i}`` ``blocks.{i}``; a ``ConvBNSiLU``'s ``conv`` / ``bn``
``conv.weight`` / ``bn.*``); the PAFPN's ``reduce{i}``, ``td_csp{i}``,
``down{i}``, ``bu_csp{i}`` and ``out{i}`` ``neck.reduce_layers.{i}``,
``top_down_blocks``, ``downsamples``, ``bottom_up_blocks`` and
``out_convs``; YOLOX's head ``stem{i}``, ``cls{i}_{j}`` / ``reg{i}_{j}``,
``cls_pred{i}`` / ``reg_pred{i}`` / ``obj_pred{i}`` ``bbox_head.stems.{i}``,
``multi_level_cls_convs.{i}.{j}`` / ``multi_level_reg_convs``,
``multi_level_conv_cls.{i}`` / ``_reg`` / ``_obj``; the DilatedEncoder's
``lateral`` / ``lateral_bn`` / ``fpn_conv`` / ``fpn_bn``
``neck.lateral_conv`` / ``lateral_norm`` / ``fpn_conv`` / ``fpn_norm`` and
``block{i}`` (``conv{j}``, ``bn{j}``)
``neck.dilated_encoder_blocks.{i}.conv{j}.{conv,bn}``; YOLOF's head
``cls_conv{i}`` / ``cls_bn{i}`` (``reg_``) ``bbox_head.cls_subnet.{i}.conv``
/ ``.bn`` (``bbox_subnet``), ``cls_score``, ``bbox_pred`` and
``object_pred`` as they are; SOLO's ``cate_conv{i}`` / ``cate_gn{i}``,
``mask_conv{i}`` / ``mask_gn{i}``, ``conv_cate`` and ``conv_mask{i}``
``bbox_head.cls_convs.{i}.conv`` / ``.gn``, ``mask_convs.{i}``,
``conv_cls`` and ``conv_mask_list.{i}``; YOLACT's ``head_conv{i}`` and
``proto_conv{i}`` ``bbox_head.head_convs.{i}.conv`` and ``proto_convs.{i}``,
``conv_cls``, ``conv_reg``, ``conv_coeff``, ``proto_out`` and ``segm_conv``
as they are (every live BN's ``batch_stats`` too).
The modules of A.2.8: DETR's ``head`` (``input_proj``, ``fc_cls``,
``fc_reg``, ``reg_fc1`` / ``reg_fc2`` ``reg_ffn.layers.0.0`` /
``reg_ffn.layers.1``, ``query_embed`` ``query_embedding.weight``) and its
``transformer/enc{i}`` / ``dec{i}`` ``bbox_head.transformer.encoder.layers.{i}``
/ ``decoder.layers.{i}``; in a layer ``self_attn`` / ``attn``
``attentions.0``, ``cross_attn`` ``attentions.1`` (flax's ``query``,
``key`` and ``value`` kernels stacked into ``attn.in_proj_weight``, ``out``
``attn.out_proj``, as Sparse R-CNN's), ``ffn`` (``fc1``, ``fc2``)
``ffns.0.layers.0.0`` / ``.1``, ``norm{k}`` (or ``norm{k}/LayerNorm_0``)
``norms.{k - 1}``; Deformable DETR's ``enc{i}`` / ``dec{i}`` the same, its
deformable attentions' ``sampling_offsets``, ``attention_weights``,
``output_proj`` as they are and ``value_proj{l}`` ``value_proj.{l}``,
``level_embed`` ``transformer.level_embeds``, ``ref_fc``
``transformer.reference_points``, ``cls{i}`` ``cls_branches.{i}``,
``reg{i}_{k}`` ``reg_branches.{i}.{2 (k - 1)}``; ChannelMapper's
``conv_{i}`` ``neck.convs.{i}.conv``; PanopticFPN's ``semantic_head``
(``lateral{i}``, ``conv{i}``, ``conv_embedding``, ``conv_seg``)
``semantic_head.{lateral_convs.{i}.conv, convs.{i}.conv,
conv_embedding.conv, conv_logits}``. ``load_mmdet_checkpoint`` reads
mmdet's 1x1-conv DETR ``input_proj`` into the dense layer and each
deformable attention's one shared ``value_proj`` into every level's
(``_detr_layout``), refuses offsets and weights of another number of
levels (mmdet's 4, the JAX ChannelMapper's 3) with ``ValueError``, and
refuses DETR's decoder ``post_norm``, ChannelMapper's extra level and GNs
and mmdet's PanopticFPNHead (``MMDET_ONLY``).
MobileNetV2, RegNet, Res2Net, ResNeSt, FPN-CARAFE and FPG: MobileNetV2's ``stem`` / ``stem_bn`` and
``conv2`` / ``conv2_bn`` become ``backbone.conv1.{conv,bn}`` and
``backbone.conv2.{conv,bn}``, a block's ``expand``, ``dw`` and ``project``
(and their ``_bn``) ``backbone.layer{s}.{b}.conv.{0,1,2}`` (``{0,1}`` where
the block has no expand conv); RegNet's ``stem`` / ``stem_bn``
``backbone.conv1`` / ``bn1`` and a block's ``bn{k}`` as they are; the deep
stem's ``stem_conv{i}`` and ``FrozenBN_{k}`` ``backbone.stem.{3 (i - 1)}``
and ``backbone.stem.{3 k + 1}``; a Bottle2neck's ``conv2_{k}`` ``convs.{k}``,
its ``FrozenBN_0`` ``bn1``, ``FrozenBN_{k}`` ``bns.{k - 1}`` and the last
``bn3``; a ResNeSt block's ``FrozenBN_0`` / ``_1`` / ``_2`` ``bn1`` /
``bn3`` / ``downsample.2`` and its split-attention ``conv2`` (``conv``,
``FrozenBN_0``, ``fc1``, ``FrozenBN_1``, ``fc2``) ``conv2.{conv, bn0, fc1,
bn1, fc2}``; an avg-down shortcut's ``downsample_conv`` / ``downsample_bn``
``downsample.1`` / ``.2`` (mmdet's ``AvgPool2d`` at ``.0``); FPN-CARAFE's
``lateral{i}``, ``carafe_comp{i}`` / ``carafe_enc{i}`` and ``fpn_conv{i}``
``neck.lateral_convs.{i}.conv``,
``neck.upsample_modules.{i - 1}.channel_compressor`` / ``.content_encoder``
and ``neck.fpn_convs.{i}``;
FPG's ``lateral{i}``, ``s{s}_down{i}``, ``s{s}_up{i}`` and ``out{i}``
``neck.lateral_convs.{i}``, ``neck.down_convs.{s}.{i - 1}``,
``neck.up_convs.{s}.{i}`` and ``neck.out_convs.{i}``. ``load_mmdet_checkpoint``
reorders a CARAFE ``content_encoder``'s outputs from mmcv's pixel-shuffle
order to the JAX package's (``carafe_mmdet_order``), refuses mmdet's
FPN-CARAFE extra P6 path and every key of mmdet's FPG (``MMDET_ONLY``), and
refuses mmdet's ResNeSt weights, whose bottlenecks are 16 times wider than
the JAX rule's (``ValueError`` naming the rule).
A leaf with no mmdet name raises. The same map carries
JAX gradients into the port's layout: ``jax_variables_to_state_dict({"params":
grads})`` gives each trainable parameter's gradient under its mmdet key.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _bn_name(scope: str) -> str:
    """Frozen-BN module path inside a backbone block / the stem (a trident
    block's fourth, ``FrozenBN_3``, is its downsample's; a RegNet block's
    ``bn{k}`` keep their names)."""
    if scope in ("downsample_bn", "FrozenBN_3"):
        return "downsample.1"
    if re.fullmatch(r"bn\d", scope):
        return scope
    m = re.fullmatch(r"FrozenBN_(\d+)", scope)
    if m is None:
        raise KeyError(scope)
    return f"bn{int(m.group(1)) + 1}"


def _conv_module(rest: Tuple[str, ...]) -> str:
    """The leaf of an mmcv ``ConvModule`` (``conv/Conv_0/kernel`` or
    ``FrozenBN_0/<leaf>``) -> its key under the module."""
    if rest[0] == "conv" and rest[-1] in ("kernel", "bias"):
        return "conv.weight" if rest[-1] == "kernel" else "conv.bias"
    if rest[0] == "FrozenBN_0":
        return f"bn.{_BN_LEAF[rest[-1]]}"
    raise KeyError("/".join(rest))


def _darknet_key(rest: Tuple[str, ...]) -> str:
    if rest[0] == "conv1":
        return f"backbone.conv1.{_conv_module(rest[1:])}"
    m = re.fullmatch(r"down(\d+)", rest[0])
    if m:
        return f"backbone.conv_res_block{m.group(1)}.conv.{_conv_module(rest[1:])}"
    stage, block = re.fullmatch(r"stage(\d+)_(\d+)", rest[0]).groups()
    return (f"backbone.conv_res_block{stage}.res{block}.{rest[1]}."
            f"{_conv_module(rest[2:])}")


def _yolo_head_key(rest: Tuple[str, ...]) -> str:
    kind, idx = re.fullmatch(r"conv_(bridge|cont|pred)(\d+)", rest[0]).groups()
    if kind == "pred":
        return f"bbox_head.convs_pred.{idx}.{'weight' if rest[-1] == 'kernel' else 'bias'}"
    return f"bbox_head.convs_{kind}.{idx}.{_conv_module(rest[1:])}"


def _leaf(rest: Tuple[str, ...]) -> str:
    """A dense or conv leaf, or a LayerNorm's or GroupNorm's -> torch's."""
    return "weight" if rest[-1] in ("kernel", "scale") else "bias"


def _block_key(pre: str, rest: Tuple[str, ...]) -> str:
    """A ResNet block's leaf (``conv{k}``, ``FrozenBN_{k}``, the downsample
    pair; the DCNv2 ``conv2`` and its ``conv_offset``) -> its key under
    ``pre``."""
    scope = rest[0]
    if scope == "downsample_conv":
        return f"{pre}.downsample.0.weight"
    if scope == "conv2_kernel":                  # the trident block's shared 3x3
        return f"{pre}.conv2.weight"
    if scope == "conv2" and rest[1] == "conv_offset":
        return f"{pre}.conv2.conv_offset.{_leaf(rest)}"
    if scope.startswith("conv"):
        return f"{pre}.{scope}.weight"
    return f"{pre}.{_bn_name(scope)}.{_BN_LEAF[rest[-1]]}"


def _merged(a, b) -> Dict:
    """Two variable trees (a collection's each) as one."""
    out = dict(a)
    for k, v in dict(b).items():
        out[k] = _merged(out[k], v) if hasattr(v, "items") and k in out else v
    return out


def backbone_kind(bb: Dict) -> str:
    """Which of MobileNetV2, RegNet, Res2Net and ResNeSt the JAX backbone tree
    (its params and statistics) is ("" another)."""
    first = dict(bb.get("layer1_0") or {})
    if "dw_bn" in first:
        return "mobilenet"
    if "stem_bn" in bb:
        return "regnet"
    if "conv2_0" in first or "FrozenBN_4" in first:
        return "res2net"
    if "FrozenBN_1" in dict(first.get("conv2") or {}):
        return "resnest"
    return ""


_MNV2_CONVS = {"expand": 0, "dw": 1, "project": 2}
_RESNEST_BNS = {"FrozenBN_0": "bn1", "FrozenBN_1": "bn3", "FrozenBN_2": "downsample.2"}


def _backbone_family_key(rest: Tuple[str, ...], bb: Dict, kind: str) -> Optional[str]:
    """A leaf of a JAX MobileNetV2, RegNet, Res2Net or ResNeSt (``kind``,
    ``bb`` its params tree) -> its key, or None (a RegNet block's, which
    ``_block_key`` maps)."""
    scope = rest[0]
    bn_leaf = lambda: _BN_LEAF[rest[-1]]                    # noqa: E731
    if kind == "mobilenet":
        if scope in ("stem", "stem_bn", "conv2", "conv2_bn"):
            mod = "conv1" if scope.startswith("stem") else "conv2"
            return f"backbone.{mod}." + (f"bn.{bn_leaf()}" if scope.endswith("_bn")
                                         else "conv.weight")
        layer, block = re.fullmatch(r"layer(\d+)_(\d+)", scope).groups()
        part = rest[1]
        idx = _MNV2_CONVS[part[:-3] if part.endswith("_bn") else part] - (
            "expand_bn" not in bb[scope])
        leaf = f"bn.{bn_leaf()}" if part.endswith("_bn") else "conv.weight"
        return f"backbone.layer{layer}.{block}.conv.{idx}.{leaf}"
    if kind == "regnet":
        if scope == "stem":
            return "backbone.conv1.weight"
        return f"backbone.bn1.{bn_leaf()}" if scope == "stem_bn" else None
    m = re.fullmatch(r"stem_conv(\d)", scope)
    if m:
        return f"backbone.stem.{3 * (int(m.group(1)) - 1)}.weight"
    m = re.fullmatch(r"FrozenBN_(\d)", scope)
    if m:
        return f"backbone.stem.{3 * int(m.group(1)) + 1}.{bn_leaf()}"
    layer, block = re.fullmatch(r"layer(\d+)_(\d+)", scope).groups()
    pre, sub = f"backbone.layer{layer}.{block}", rest[1]
    if sub == "downsample_conv":
        return f"{pre}.downsample.1.weight"
    if sub in ("conv1", "conv3"):
        return f"{pre}.{sub}.weight"
    if kind == "res2net":
        m = re.fullmatch(r"conv2_(\d+)", sub)
        if m:
            return f"{pre}.convs.{m.group(1)}.weight"
        if sub == "downsample_bn":
            return f"{pre}.downsample.2.{bn_leaf()}"
        k = int(re.fullmatch(r"FrozenBN_(\d+)", sub).group(1))
        scales = max(int(c[9:]) for c in bb[scope] if re.fullmatch(r"FrozenBN_\d+", c))
        name = "bn1" if k == 0 else "bn3" if k == scales else f"bns.{k - 1}"
        return f"{pre}.{name}.{bn_leaf()}"
    if sub in _RESNEST_BNS:
        return f"{pre}.{_RESNEST_BNS[sub]}.{bn_leaf()}"
    part = rest[2]                                   # the split-attention conv2
    if part in ("FrozenBN_0", "FrozenBN_1"):
        return f"{pre}.conv2.bn{part[-1]}.{bn_leaf()}"
    return f"{pre}.conv2.{part}.{_leaf(rest)}"


def neck_kind(neck: Dict) -> str:
    """``carafe`` or ``fpg`` for the JAX FPN_CARAFE and FPG necks ("" another)."""
    if "carafe_comp1" in neck:
        return "carafe"
    return "fpg" if any(re.fullmatch(r"s\d+_(down|up)\d+", k) for k in neck) else ""


def _carafe_fpg_key(rest: Tuple[str, ...], kind: str) -> str:
    """A leaf of a JAX FPN_CARAFE or FPG neck -> its key."""
    m = re.fullmatch(r"(lateral|carafe_comp|carafe_enc|fpn_conv|out)(\d+)", rest[0])
    if m:
        part, i = m.group(1), int(m.group(2))
        if part == "lateral":
            return f"neck.lateral_convs.{i}.{'conv.' if kind == 'carafe' else ''}{_leaf(rest)}"
        if part.startswith("carafe"):
            mod = "channel_compressor" if part == "carafe_comp" else "content_encoder"
            return f"neck.upsample_modules.{i - 1}.{mod}.{_leaf(rest)}"
        group = "fpn_convs" if part == "fpn_conv" else "out_convs"
        return f"neck.{group}.{i}.{_conv_module(rest[1:])}"
    stack, part, i = re.fullmatch(r"s(\d+)_(down|up)(\d+)", rest[0]).groups()
    idx = int(i) - 1 if part == "down" else int(i)
    return f"neck.{part}_convs.{stack}.{idx}.{_conv_module(rest[1:])}"


# JAX dense-head scopes -> mmdet's module names (the rest keep their name)
_DENSE_NAMES = {"conv_ctr": "conv_centerness", "bucket_cls": "retina_bbox_cls",
                "bucket_reg": "retina_bbox_reg",
                "reg_refine_dconv": "vfnet_reg_refine_dconv", "cls_dconv": "vfnet_cls_dconv",
                "reg_refine_gn": "vfnet_reg_refine_gn", "cls_gn": "vfnet_cls_gn",
                "cls_prob_conv1": "cls_prob_module.0", "cls_prob_conv2": "cls_prob_module.2",
                "reg_offset_conv1": "reg_offset_module.0",
                "reg_offset_conv2": "reg_offset_module.2"}
_DENSE_CONVS = set(_DENSE_NAMES) | {
    "retina_cls", "retina_reg", "retina_iou", "conv_cls", "conv_reg", "atss_cls", "atss_reg",
    "atss_centerness", "gfl_cls", "gfl_reg", "vfnet_reg", "vfnet_reg_refine", "vfnet_cls",
    "tood_cls", "tood_reg", "conv_loc", "conv_shape"}
_DENSE_SCALES = {"scales": "scales", "reg_scales": "scales", "scales_refine": "scales_refine"}
_DECOMP = {"la_conv1": "layer_attention.0", "la_conv2": "layer_attention.2",
           "reduction_conv": "reduction_conv.conv", "gn": "reduction_conv.gn"}
_ADAPT = {"adapt_cls": "feature_adaption_cls", "adapt_reg": "feature_adaption_reg"}
# JAX NAS-FPN cells -> mmdet's names (``gp_55_7``: a cell mmdet lacks)
_NAS_CELLS = {"gp64_4": "gp_64_4", "sum44": "sum_44_4", "sum43": "sum_43_3", "sum34": "sum_34_4",
              "gp43_5": "gp_43_5", "sum55": "sum_55_5", "gp55_7": "gp_55_7", "gp75_6": "gp_75_6"}


_REPPOINTS = {"cls_dconv": "reppoints_cls_conv", "cls_out": "reppoints_cls_out",
              "pts_init_conv": "reppoints_pts_init_conv",
              "pts_init_out": "reppoints_pts_init_out",
              "pts_refine_dconv": "reppoints_pts_refine_conv",
              "pts_refine_out": "reppoints_pts_refine_out", "cls_gn_out": "cls_gn_out",
              "pts_refine_gn": "pts_refine_gn"}
_CENTERNET = {f"{b}_{k}": f"{b}_head.{i}" for b in ("heatmap", "wh", "offset")
              for k, i in (("conv", 0), ("out", 2))}
_CORNER_POOL = {"conv1": "direction1_conv", "conv2": "direction2_conv",
                "out_conv": "aftpool_conv", "shortcut": "conv1"}
_CORNER_BRANCH = {"heat": "heat", "emb": "emb", "off": "off", "ctr": "centripetal_shift"}


def _point_head_key(rest: Tuple[str, ...], reppoints: bool) -> Optional[str]:
    """A leaf of RepPoints' (``reppoints``), CenterNet's or a corner head
    -> its key, or None (another head's)."""
    scope = rest[0]
    if reppoints and scope == "moment_transfer":
        return "bbox_head.moment_transfer"
    if reppoints and scope in _REPPOINTS:
        return f"bbox_head.{_REPPOINTS[scope]}.{_leaf(rest)}"
    if scope in _CENTERNET:
        return f"bbox_head.{_CENTERNET[scope]}.{_leaf(rest)}"
    m = re.fullmatch(r"(tl|br)_(heat|emb|off|ctr)(\d+)_c([12])", scope)
    if m:
        side, kind, i, k = m.groups()
        return (f"bbox_head.{side}_{_CORNER_BRANCH[kind]}.{i}.{int(k) - 1}.conv."
                f"{_leaf(rest)}")
    m = re.fullmatch(r"(tl|br)_pool(\d+)", scope)
    if m:
        return (f"bbox_head.{m.group(1)}_pool.{m.group(2)}.{_CORNER_POOL[rest[1]]}."
                f"{_conv_module(rest[2:])}")
    return None


def _hourglass_key(rest: Tuple[str, ...]) -> str:
    """A leaf of the JAX ``HourglassNet`` -> its key under ``backbone.``."""
    scope = rest[0]
    if scope == "stem_conv":
        return f"backbone.stem.0.{_conv_module(rest[1:])}"
    m = re.fullmatch(r"(stem_res|inter_res)(\d+)(_\d+)?", scope)
    if m and m.group(1) == "stem_res":
        return _block_key(f"backbone.stem.1.{m.group(2)}", rest[1:])
    if m:
        return _block_key(f"backbone.inters.{m.group(2)}", rest[1:])
    m = re.fullmatch(r"(out_conv|remap_x|remap_f)(\d+)", scope)
    if m:
        group = {"out_conv": "out_convs", "remap_x": "conv1x1s",
                 "remap_f": "remap_convs"}[m.group(1)]
        return f"backbone.{group}.{m.group(2)}.{_conv_module(rest[1:])}"
    stack = re.fullmatch(r"hg(\d+)", scope).group(1)
    pre, rest = f"backbone.hourglass_modules.{stack}", rest[1:]
    while rest[0] == "low2":                     # a nested level
        pre, rest = f"{pre}.low2", rest[1:]
    part, j = re.fullmatch(r"(up1|low1|low2|low3)_(\d+)", rest[0]).groups()
    return _block_key(f"{pre}.{part}.{j}", rest[1:])


def _dense_head_key(rest: Tuple[str, ...], sepbn: bool = False) -> Optional[str]:
    """A leaf of RetinaNet's or a one-stage family head -> its mmdet key, or
    None (another head's). A per-level ``scales`` vector maps to
    ``...scales.{}.scale``, one key a level; a tower conv of a head with
    per-level BNs (``sepbn``) to ``..._convs.{level}.i.conv``, one key a
    level (the levels share it)."""
    scope = rest[0]
    m = re.fullmatch(r"(cls|reg)_bn(\d+)_(\d+)", scope)
    if m:                                        # RetinaSepBNHead's per-level BNs
        return (f"bbox_head.{m.group(1)}_convs.{m.group(2)}.{m.group(3)}.bn."
                f"{_BN_LEAF[rest[-1]]}")
    m = re.fullmatch(r"(cls|reg|inter)_(conv|gn|sep)(\d+)", scope)
    if m and sepbn:
        return f"bbox_head.{m.group(1)}_convs.{{level}}.{m.group(3)}.conv.{_leaf(rest)}"
    if m:                                        # NAS-FCOS's ``cls_sep{i}``: a tower conv
        part = "gn" if m.group(2) == "gn" else "conv"
        return f"bbox_head.{m.group(1)}_convs.{m.group(3)}.{part}.{_leaf(rest)}"
    if scope in _ADAPT:
        if rest[1] == "conv_offset":
            return f"bbox_head.{_ADAPT[scope]}.conv_offset.{_leaf(rest)}"
        return f"bbox_head.{_ADAPT[scope]}.conv_adaption.weight"
    if scope in _DENSE_SCALES:
        return f"bbox_head.{_DENSE_SCALES[scope]}.{{}}.scale"
    if scope in ("center_prior_mean", "center_prior_sigma"):
        return f"bbox_head.center_prior.{scope.rsplit('_', 1)[1]}"
    if scope in ("cls_decomp", "reg_decomp"):
        return f"bbox_head.{scope}.{_DECOMP[rest[1]]}.{_leaf(rest)}"
    if scope in _DENSE_CONVS:
        return f"bbox_head.{_DENSE_NAMES.get(scope, scope)}.{_leaf(rest)}"
    return None


def _nas_neck_key(rest: Tuple[str, ...], laterals: str) -> Optional[str]:
    """A leaf of a JAX NAS-FPN or NAS-FCOS neck -> its key under ``neck.``
    (``laterals``: the laterals' module list, ``lateral_convs`` or
    ``adapt_convs``), or None (an FPN's)."""
    m = re.fullmatch(r"lateral(\d+)", rest[0])
    if m:
        return f"neck.{laterals}.{m.group(1)}.{_conv_module(rest[1:])}"
    m = re.fullmatch(r"merge(\d+)", rest[0])
    if m:
        return f"neck.merge_convs.{int(m.group(1)) - 1}.{_conv_module(rest[1:])}"
    m = re.fullmatch(r"s(\d+)_(\w+)", rest[0])
    if m and m.group(2) in _NAS_CELLS and rest[1] == "out_conv":
        return (f"neck.fpn_stages.{m.group(1)}.{_NAS_CELLS[m.group(2)]}.out_conv."
                f"{_conv_module(rest[2:])}")
    return None


# SSDVGG's convs -> their index in mmdet's ``features`` Sequential
_VGG_STAGE = (0, 5, 10, 17, 24)
_VGG_FC = {"conv6": 31, "conv7": 33}
_YOLOF_TOWER = {"cls": "cls_subnet", "reg": "bbox_subnet"}
_YOLOX_TOWER = {"cls": "multi_level_cls_convs", "reg": "multi_level_reg_convs"}
_YOLOX_PRED = {"cls_pred": "multi_level_conv_cls", "reg_pred": "multi_level_conv_reg",
               "obj_pred": "multi_level_conv_obj"}
_PAFPN = {"reduce": "reduce_layers", "down": "downsamples", "out": "out_convs",
          "td_csp": "top_down_blocks", "bu_csp": "bottom_up_blocks"}
_SOLO = {"cate_conv": "cls_convs.{}.conv", "cate_gn": "cls_convs.{}.gn",
         "mask_conv": "mask_convs.{}.conv", "mask_gn": "mask_convs.{}.gn",
         "conv_mask": "conv_mask_list.{}", "head_conv": "head_convs.{}.conv",
         "proto_conv": "proto_convs.{}"}


def _cbs(rest: Tuple[str, ...]) -> str:
    """A leaf of a JAX ``ConvBNSiLU`` (``conv/kernel``, ``bn/<leaf>``) ->
    its key under the port's module."""
    if rest[0] == "conv":
        return "conv.weight"
    if rest[0] == "bn":
        return f"bn.{_BN_LEAF[rest[-1]]}"
    raise KeyError("/".join(rest))


def _csp_key(rest: Tuple[str, ...]) -> str:
    """A leaf of a JAX ``CSPLayer`` -> its key under the port's."""
    if rest[0] in ("main_conv", "short_conv", "final_conv"):
        return f"{rest[0]}.{_cbs(rest[1:])}"
    block = re.fullmatch(r"block(\d+)", rest[0]).group(1)
    return f"blocks.{block}.{rest[1]}.{_cbs(rest[2:])}"


def _fifth_key(head: str, rest: Tuple[str, ...], kind: str) -> Optional[str]:
    """A leaf of SSDVGG, CSPDarknet, YOLOXPAFPN, DilatedEncoder or the YOLOF,
    YOLOX, SSD, SOLO and YOLACT heads (``kind``: which head) -> its key, or
    None (another module's)."""
    scope = rest[0]
    if head == "backbone_m":
        m = re.fullmatch(r"conv(\d)_(\d)", scope)
        if m:
            idx = _VGG_STAGE[int(m.group(1)) - 1] + 2 * (int(m.group(2)) - 1)
            return f"backbone.features.{idx}.{_leaf(rest)}"
        if scope in _VGG_FC:
            return f"backbone.features.{_VGG_FC[scope]}.{_leaf(rest)}"
        m = re.fullmatch(r"extra(\d+)", scope)
        if m:
            return f"backbone.extra.{m.group(1)}.{_leaf(rest)}"
        if scope == "l2_norm_scale_p":
            return "backbone.l2_norm.weight"
        if scope == "stem" and rest[1] in ("conv", "bn"):
            return f"backbone.stem.conv.{_cbs(rest[1:])}"
        m = re.fullmatch(r"stage(\d+)_(conv|spp|csp)", scope)
        if m:                                    # P5: the SPP is stage 4's
            k, part = m.groups()
            if part == "conv":
                return f"backbone.stage{k}.0.{_cbs(rest[1:])}"
            if part == "spp":
                return f"backbone.stage{k}.1.{rest[1]}.{_cbs(rest[2:])}"
            return f"backbone.stage{k}.{2 if k == '4' else 1}.{_csp_key(rest[1:])}"
        return None
    if head == "neck_m":
        m = re.fullmatch(r"(reduce|down|out|td_csp|bu_csp)(\d+)", scope)
        if m:
            sub = _csp_key(rest[1:]) if m.group(1).endswith("csp") else _cbs(rest[1:])
            return f"neck.{_PAFPN[m.group(1)]}.{m.group(2)}.{sub}"
        if scope in ("lateral", "fpn_conv"):
            return f"neck.{'lateral_conv' if scope == 'lateral' else 'fpn_conv'}.{_leaf(rest)}"
        if scope in ("lateral_bn", "fpn_bn"):
            return f"neck.{scope[:-3]}_norm.{_BN_LEAF[rest[-1]]}"
        m = re.fullmatch(r"block(\d+)", scope)
        if m:
            conv, part = re.fullmatch(r"(?:conv|bn)(\d)", rest[1]).group(1), rest[1][:-1]
            leaf = _leaf(rest) if part == "conv" else _BN_LEAF[rest[-1]]
            return f"neck.dilated_encoder_blocks.{m.group(1)}.conv{conv}.{part}.{leaf}"
        return None
    if head != "head":
        return None
    m = re.fullmatch(r"(cls|reg)_(conv|bn)(\d+)", scope)
    if kind == "yolof" and m:
        leaf = _leaf(rest) if m.group(2) == "conv" else _BN_LEAF[rest[-1]]
        return f"bbox_head.{_YOLOF_TOWER[m.group(1)]}.{m.group(3)}.{m.group(2)}.{leaf}"
    if kind == "ssd" and m and m.group(2) == "conv":
        return f"bbox_head.{m.group(1)}_convs.{m.group(3)}.{_leaf(rest)}"
    if kind == "yolox":
        m = re.fullmatch(r"(stem|cls|reg)(\d+)(?:_(\d+))?", scope)
        if m and m.group(1) == "stem":
            return f"bbox_head.stems.{m.group(2)}.{_cbs(rest[1:])}"
        if m:
            return f"bbox_head.{_YOLOX_TOWER[m.group(1)]}.{m.group(2)}.{m.group(3)}.{_cbs(rest[1:])}"
        m = re.fullmatch(r"(cls_pred|reg_pred|obj_pred)(\d+)", scope)
        if m:
            return f"bbox_head.{_YOLOX_PRED[m.group(1)]}.{m.group(2)}.{_leaf(rest)}"
    if kind in ("solo", "yolact"):
        m = re.fullmatch(r"(cate_conv|cate_gn|mask_conv|mask_gn|conv_mask|head_conv|proto_conv)"
                         r"(\d+)", scope)
        if m:
            return f"bbox_head.{_SOLO[m.group(1)].format(m.group(2))}.{_leaf(rest)}"
        if scope == "conv_cate":
            return f"bbox_head.conv_cls.{_leaf(rest)}"
        if scope in ("conv_coeff", "proto_out", "segm_conv"):
            return f"bbox_head.{scope}.{_leaf(rest)}"
    if kind == "yolof" and scope in ("cls_score", "bbox_pred", "object_pred"):
        return f"bbox_head.{scope}.{_leaf(rest)}"
    return None


def _head_kind(heads: Dict) -> str:
    """Which of the fifth slice's heads the JAX head tree is ("" none)."""
    for kind, leaf in (("yolof", "object_pred"), ("yolof", "cls_bn0"), ("yolox", "stem0"),
                       ("solo", "conv_cate"), ("yolact", "proto_out"), ("detr", "query_embed")):
        if leaf in heads:
            return kind
    if heads and all(re.fullmatch(r"(cls|reg)_conv\d+", k) for k in heads):
        return "ssd"
    return ""


def _torch_key(path: Tuple[str, ...], fpn_levels: int = 0, sepbn: bool = False,
               laterals: str = "lateral_convs", reppoints: bool = False,
               kind: str = "", backbone: Optional[Dict] = None, neck: str = "") -> str:
    """Flax leaf path (collection dropped) -> mmdet state_dict key;
    ``fpn_levels`` is the FPN's lateral count (its ``extra_conv_k`` is
    ``fpn_convs.{fpn_levels + k}``), ``sepbn`` whether the dense head has
    per-level BNs, ``laterals`` a NAS neck's lateral list, ``backbone`` the
    JAX backbone's params tree, ``neck`` the neck's ``neck_kind``. A KD
    detector's ``teacher`` subtree (a detector's ``backbone_m``, ``neck_m``
    and ``head``) goes under mmdet's ``teacher_model.``."""
    head, rest = path[0], path[1:]
    if head == "teacher":
        return f"teacher_model.{_torch_key(rest, fpn_levels)}"
    bb_kind = backbone_kind(backbone) if head == "backbone_m" and backbone else ""
    key = _backbone_family_key(rest, backbone, bb_kind) if bb_kind else None
    if key is not None:
        return key
    if head == "neck_m" and neck:
        return _carafe_fpg_key(rest, neck)
    fifth = _fifth_key(head, rest, kind)
    if fifth is not None:
        return fifth
    if head == "backbone_m" and (re.fullmatch(r"down\d+|stage\d+_\d+", rest[0]) or (
            rest[0] == "conv1" and rest[1] in ("conv", "FrozenBN_0"))):
        return _darknet_key(rest)
    if head == "neck_m" and re.fullmatch(r"detect\d+", rest[0]):
        return f"neck.{rest[0]}.{rest[1]}.{_conv_module(rest[2:])}"
    if head == "neck_m" and re.fullmatch(r"conv\d+", rest[0]):
        return f"neck.{rest[0]}.{_conv_module(rest[1:])}"
    if head == "head" and kind == "detr":
        return _detr_key(rest)
    if head == "head":
        return (_point_head_key(rest, reppoints) or _dense_head_key(rest, sepbn)
                or _yolo_head_key(rest))
    if head == "semantic_head":                      # PanopticFPN's
        return _semantic_key("semantic_head", rest)
    if head == "neck_m" and re.fullmatch(r"conv_\d+", rest[0]):     # ChannelMapper
        return f"neck.convs.{rest[0][5:]}.{_conv_module(rest[1:])}"
    if head == "neck_m" and _nas_neck_key(rest, laterals):
        return _nas_neck_key(rest, laterals)
    if head == "backbone_m" and re.fullmatch(
            r"stem_conv|stem_res\d+|hg\d+|out_conv\d+|remap_[xf]\d+|inter_res\d+_\d+", rest[0]):
        return _hourglass_key(rest)
    if head == "backbone_m":
        if rest[0] == "conv1":                       # stem conv
            return "backbone.conv1.weight"
        if rest[0].startswith("FrozenBN_"):          # stem BN
            return f"backbone.bn1.{_BN_LEAF[rest[-1]]}"
        layer, block = re.fullmatch(r"layer(\d+)_(\d+)", rest[0]).groups()
        return _block_key(f"backbone.layer{layer}.{block}", rest[1:])
    if head == "neck_m":
        kind, idx = re.fullmatch(r"(lateral|fpn_conv|extra_conv)_(\d+)", rest[0]).groups()
        group = "lateral_convs" if kind == "lateral" else "fpn_convs"
        if kind == "extra_conv":
            idx = fpn_levels + int(idx)
        return f"neck.{group}.{idx}.conv.{_leaf(rest)}"
    if head == "rpn" and rest[0] in ("init_proposal_bboxes", "init_proposal_features"):
        return f"rpn_head.{rest[0]}.weight"
    if head == "rpn":
        leaf = "weight" if rest[-1] == "kernel" else "bias"
        return f"rpn_head.{rest[0]}.{leaf}"
    if head == "roi" and rest[0] == "shared_head_m":
        layer, block = re.fullmatch(r"layer(\d+)_(\d+)", rest[1]).groups()
        return _block_key(f"roi_head.shared_head.layer{layer}.{block}", rest[2:])
    if head == "roi":
        return _roi_key(rest)
    raise KeyError("/".join(path))


def _mask_head_key(pre: str, rest: Tuple[str, ...]) -> str:
    m = re.fullmatch(r"conv_(\d+)", rest[0])
    if m:
        return f"{pre}.convs.{m.group(1)}.conv.{_leaf(rest)}"
    if rest[0] in ("upsample", "conv_logits"):
        return f"{pre}.{rest[0]}.{_leaf(rest)}"
    raise KeyError("/".join(rest))


def _box_head_key(pre: str, rest: Tuple[str, ...]) -> str:
    name = rest[0]
    m = re.fullmatch(r"(shared_fc|fc_cont|fc|res)(\d+)(_conv\d)?", name)
    if m and m.group(1) == "res":                # the double head's bottlenecks
        return f"{pre}.conv_branch.{m.group(2)}.{m.group(3)[1:]}.weight"
    if m:
        group = {"shared_fc": "shared_fcs", "fc_cont": "fc_cont", "fc": "fc_branch"}[m.group(1)]
        return f"{pre}.{group}.{m.group(2)}.{_leaf(rest)}"
    if name in ("fc_cls", "fc_reg", "conv_in"):
        return f"{pre}.{name}.{_leaf(rest)}"
    raise KeyError("/".join(rest))


_DII = {"norm1": "attention_norm", "dynamic_gen": "instance_interactive_conv.dynamic_layer",
        "dn1": "instance_interactive_conv.norm_in", "dn2": "instance_interactive_conv.norm_out",
        "out_proj": "instance_interactive_conv.fc_layer",
        "norm2": "instance_interactive_conv_norm", "ffn1": "ffn.layers.0.0",
        "ffn2": "ffn.layers.1", "norm3": "ffn_norm", "fc_cls": "fc_cls", "fc_reg": "fc_reg"}
_QKV = ("query", "key", "value")


def _dii_key(pre: str, rest: Tuple[str, ...]) -> str:
    """A leaf of a JAX ``DIIHead`` -> its key under ``pre``; the attention's
    query, key and value leaves get ``#0``..``#2``, the parts of mmdet's
    stacked ``in_proj_weight`` / ``in_proj_bias``."""
    scope = rest[0]
    if scope == "self_attn":
        if rest[1] in _QKV:
            part = "in_proj_weight" if rest[-1] == "kernel" else "in_proj_bias"
            return f"{pre}.attention.attn.{part}#{_QKV.index(rest[1])}"
        if rest[1] == "out":
            return f"{pre}.attention.attn.out_proj.{_leaf(rest)}"
    m = re.fullmatch(r"(cls|reg)_(fc|ln)(\d+)", scope)
    if m:
        idx = 3 * int(m.group(3)) + (m.group(2) == "ln")
        return f"{pre}.{m.group(1)}_fcs.{idx}.{_leaf(rest)}"
    if scope in _DII:
        return f"{pre}.{_DII[scope]}.{_leaf(rest)}"
    raise KeyError("/".join(rest))


def _semantic_key(pre: str, rest: Tuple[str, ...]) -> str:
    """A leaf of a JAX ``FusedSemanticHead`` -> its key under ``pre``."""
    m = re.fullmatch(r"(lateral|conv)(\d+)", rest[0])
    if m:
        group = "lateral_convs" if m.group(1) == "lateral" else "convs"
        return f"{pre}.{group}.{m.group(2)}.conv.{_leaf(rest)}"
    if rest[0] == "conv_embedding":
        return f"{pre}.conv_embedding.conv.{_leaf(rest)}"
    if rest[0] == "conv_seg":
        return f"{pre}.conv_logits.{_leaf(rest)}"
    raise KeyError("/".join(rest))


_DETR_NAMES = {"input_proj": "input_proj", "fc_cls": "fc_cls", "fc_reg": "fc_reg",
               "reg_fc1": "reg_ffn.layers.0.0", "reg_fc2": "reg_ffn.layers.1",
               "ref_fc": "transformer.reference_points"}
_FFN = {"fc1": "ffns.0.layers.0.0", "fc2": "ffns.0.layers.1"}
_ATTENTIONS = {"attn": 0, "self_attn": 0, "cross_attn": 1}


def _transformer_layer_key(pre: str, rest: Tuple[str, ...]) -> str:
    """A leaf of a JAX (deformable) encoder or decoder layer -> its key
    under ``pre``: ``norm{k}`` ``norms.{k - 1}``, ``ffn`` ``ffns.0``,
    ``attn`` / ``self_attn`` ``attentions.0`` and ``cross_attn``
    ``attentions.1``; flax attention's ``query`` / ``key`` / ``value`` get
    ``#0``..``#2`` (the parts of ``attn.in_proj_*``), its ``out``
    ``attn.out_proj``; the deformable one's ``value_proj{l}``
    ``value_proj.{l}``."""
    scope = rest[0]
    if scope == "ffn":
        return f"{pre}.{_FFN[rest[1]]}.{_leaf(rest)}"
    m = re.fullmatch(r"norm(\d)", scope)
    if m:
        return f"{pre}.norms.{int(m.group(1)) - 1}.{_leaf(rest)}"
    att = f"{pre}.attentions.{_ATTENTIONS[scope]}"
    if rest[1] in _QKV:
        part = "in_proj_weight" if rest[-1] == "kernel" else "in_proj_bias"
        return f"{att}.attn.{part}#{_QKV.index(rest[1])}"
    if rest[1] == "out":
        return f"{att}.attn.out_proj.{_leaf(rest)}"
    m = re.fullmatch(r"value_proj(\d+)", rest[1])
    if m:
        return f"{att}.value_proj.{m.group(1)}.{_leaf(rest)}"
    if rest[1] in ("sampling_offsets", "attention_weights", "output_proj"):
        return f"{att}.{rest[1]}.{_leaf(rest)}"
    raise KeyError("/".join(rest))


def _detr_key(rest: Tuple[str, ...]) -> Optional[str]:
    """A leaf of the JAX ``DETRHead`` or ``DeformableDETRHead`` -> its key,
    or None (another head's)."""
    if rest[0] == "transformer":                 # DETR's Transformer module
        rest = rest[1:]
    m = re.fullmatch(r"(enc|dec)(\d+)", rest[0])
    if m:
        stack = "encoder" if m.group(1) == "enc" else "decoder"
        return _transformer_layer_key(f"bbox_head.transformer.{stack}.layers.{m.group(2)}",
                                      rest[1:])
    if rest[0] == "query_embed":
        return "bbox_head.query_embedding.weight"
    if rest[0] == "level_embed":
        return "bbox_head.transformer.level_embeds"
    if rest[0] in _DETR_NAMES:
        return f"bbox_head.{_DETR_NAMES[rest[0]]}.{_leaf(rest)}"
    m = re.fullmatch(r"cls(\d+)", rest[0])
    if m:
        return f"bbox_head.cls_branches.{m.group(1)}.{_leaf(rest)}"
    m = re.fullmatch(r"reg(\d+)_(\d)", rest[0])
    if m:
        return f"bbox_head.reg_branches.{m.group(1)}.{2 * (int(m.group(2)) - 1)}.{_leaf(rest)}"
    return None


def _roi_key(rest: Tuple[str, ...]) -> str:
    """A leaf under the JAX RoI head ``roi`` -> its key under ``roi_head``."""
    scope = rest[0]
    m = re.fullmatch(r"dii(\d+)", scope)
    if m:                                        # Sparse R-CNN's stages
        return _dii_key(f"roi_head.bbox_head.{m.group(1)}", rest[1:])
    if scope == "grid":
        m = re.fullmatch(r"(conv|gn)(\d+)", rest[1])
        if m and m.group(1) == "conv":
            return f"roi_head.grid_head.convs.{m.group(2)}.conv.{_leaf(rest)}"
        if m:
            return f"roi_head.grid_head.convs.{m.group(2)}.gn.{_leaf(rest)}"
        if rest[1] in ("deconv1", "deconv2"):
            return f"roi_head.grid_head.{rest[1]}.{_leaf(rest)}"
    if scope == "point":
        m = re.fullmatch(r"fc(\d+)", rest[1])
        if m:
            return f"roi_head.point_head.fcs.{m.group(1)}.conv.{_leaf(rest)}"
        if rest[1] == "fc_logits":
            return f"roi_head.point_head.fc_logits.{_leaf(rest)}"
    if scope == "shared_head_m":
        layer, block = re.fullmatch(r"layer(\d+)_(\d+)", rest[1]).groups()
        return _block_key(f"roi_head.shared_head.layer{layer}.{block}", rest[2:])
    if scope == "mask_head_m":
        return _mask_head_key("roi_head.mask_head", rest[1:])
    if scope == "head":
        return _box_head_key("roi_head.bbox_head", rest[1:])
    m = re.fullmatch(r"(heads|mask_heads)_(\d+)", scope)
    if m and m.group(1) == "heads":              # a cascade's stages
        return _box_head_key(f"roi_head.bbox_head.{m.group(2)}", rest[1:])
    if m:
        return _mask_head_key(f"roi_head.mask_head.{m.group(2)}", rest[1:])
    m = re.fullmatch(r"info_conv(\d+)", scope)
    if m:
        return f"roi_head.info_convs.{m.group(1)}.{_leaf(rest)}"
    if scope == "semantic":
        return _semantic_key("roi_head.semantic_head", rest[1:])
    if scope == "glbctx":
        m = re.fullmatch(r"conv(\d+)", rest[1])
        if m:
            return f"roi_head.glbctx_head.convs.{m.group(1)}.conv.{_leaf(rest)}"
        if rest[1] == "fc":
            return f"roi_head.glbctx_head.fc.{_leaf(rest)}"
    if scope == "maskiou":
        m = re.fullmatch(r"(conv|fc)(\d+)", rest[1])
        if m:
            group = "convs" if m.group(1) == "conv" else "fcs"
            return f"roi_head.mask_iou_head.{group}.{m.group(2)}.{_leaf(rest)}"
        if rest[1] == "iou_pred":
            return f"roi_head.mask_iou_head.fc_mask_iou.{_leaf(rest)}"
    raise KeyError("/".join(rest))


def _roi_channels(width: int, roi_feat_size: int, given: Optional[int]) -> int:
    """The RoI channel count behind a first shared FC of input ``width``."""
    s2 = roi_feat_size * roi_feat_size
    if width % s2 or (given is not None and width != given * s2):
        raise ValueError(f"shared_fcs.0 takes {width} inputs, not {roi_feat_size}x"
                         f"{roi_feat_size} RoI features of "
                         f"{given if given is not None else 'any whole number of'} "
                         "channels")
    return width // s2


def jax_variables_to_state_dict(variables: Dict, roi_feat_size: int = 7,
                                roi_channels: Optional[int] = None
                                ) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX two-stage or
    YOLOv3 detector (numpy or jax arrays) -> the port's ``state_dict`` (CPU float tensors).
    ``roi_channels`` (the RoI extractor's ``out_channels``), when given,
    must equal the first shared FC's input width over ``roi_feat_size ** 2``;
    a width that ``roi_feat_size ** 2`` does not divide raises."""
    sd: Dict[str, torch.Tensor] = {}
    params = dict(variables.get("params") or {})
    fpn_levels = {scope: sum(1 for k in (tree.get("neck_m") or {})
                             if re.fullmatch(r"lateral_\d+", k))
                  for scope, tree in (("", params), ("teacher", params.get("teacher") or {}))}
    heads = dict(params.get("head") or {})
    sepbn = sum(1 for k in heads if re.fullmatch(r"cls_bn\d+_0", k))
    reppoints = "pts_init_out" in heads
    kind = _head_kind(heads or dict(dict(variables.get("batch_stats") or {}).get("head") or {}))
    neck = dict(params.get("neck_m") or {})
    laterals = ("adapt_convs" if any(re.fullmatch(r"merge\d+", k) for k in neck)
                else "lateral_convs")
    stats = dict(variables.get("batch_stats") or {})
    backbone = _merged(params.get("backbone_m") or {}, stats.get("backbone_m") or {})
    necks = neck_kind(_merged(neck, stats.get("neck_m") or {}))
    maskiou = dict(dict(params.get("roi") or {}).get("maskiou") or {})
    convs = sorted((k for k in maskiou if re.fullmatch(r"conv\d+", k)), key=lambda k: int(k[4:]))
    maskiou_ch = (np.asarray(maskiou[convs[-1]]["Conv_0"]["kernel"]).shape[-1]
                  if convs else None)
    parts: Dict[str, Dict[int, np.ndarray]] = {}
    for collection in ("params", "batch_stats"):
        for path, v in _leaves(variables.get(collection) or {}):
            try:
                key = _torch_key(path, fpn_levels["teacher" if path[0] == "teacher" else ""],
                                 sepbn > 0, laterals, reppoints, kind, backbone, necks)
            except (KeyError, AttributeError) as e:
                raise KeyError(f"no mmdet name for {collection}/"
                               f"{'/'.join(path)}") from e
            if "{level}" in key:                        # a conv the levels share
                for li in range(sepbn):
                    sd[key.format(level=li)] = torch.tensor(
                        np.asarray(v, np.float32).transpose(3, 2, 0, 1) if v.ndim == 4
                        else np.asarray(v, np.float32))
                continue
            if "{}" in key:                             # a per-level scales vector
                for i, x in enumerate(np.asarray(v, dtype=np.float32)):
                    sd[key.format(i)] = torch.tensor(x)
                continue
            if "#" in key:                              # a part of in_proj_*
                parts.setdefault(key.split("#")[0], {})[int(key.split("#")[1])] = (
                    v.reshape(v.shape[0], -1).T if path[-1] == "kernel" else v.reshape(-1))
                continue
            if key.endswith(".attn.out_proj.weight"):              # (heads, dim, E)
                v = v.reshape(-1, v.shape[-1]).T
            elif path[-1] == "conv2_kernel":              # HWIO -> OIHW
                v = v.transpose(3, 2, 0, 1)
            elif path[-1] == "kernel" and ".point_head." in key:   # (in, out) -> (out, in, 1)
                v = v.T[..., None]
            elif path[-1] == "kernel":
                if re.fullmatch(r"roi_head\.(mask_head\.(\d+\.)?upsample|grid_head\.deconv\d)"
                                r"\.weight", key):
                    # flipped, (in, out, kh, kw)
                    v = np.ascontiguousarray(v[::-1, ::-1].transpose(2, 3, 0, 1))
                elif v.ndim == 4:                        # HWIO -> OIHW
                    v = v.transpose(3, 2, 0, 1)
                else:                                    # (in, out) -> (out, in)
                    v = v.T
                    if re.fullmatch(r"roi_head\.bbox_head\.(\d+\.)?(shared_fcs|fc_branch)"
                                    r"\.0\.weight", key):
                        v = _hwc_to_chw(v, roi_feat_size,
                                        _roi_channels(v.shape[1], roi_feat_size, roi_channels))
                    elif key == "roi_head.mask_iou_head.fcs.0.weight":
                        side = int(round(np.sqrt(v.shape[1] // maskiou_ch)))
                        v = _hwc_to_chw(v, side, maskiou_ch)
            sd[key] = torch.tensor(np.asarray(v, dtype=np.float32))
    for key, got in parts.items():
        sd[key] = torch.tensor(np.concatenate([np.asarray(got[i], np.float32)
                                               for i in range(len(_QKV))]))
    return sd


def _hwc_to_chw(w: np.ndarray, side: int, channels: int) -> np.ndarray:
    """An (out, side * side * channels) FC weight whose inputs are flattened
    H, W, C (the JAX package's NHWC features) -> inputs flattened C, H, W."""
    o, i = w.shape
    return (w.reshape(o, side, side, channels).transpose(0, 3, 1, 2).reshape(o, i))


_SECTIONS = ("backbone.", "neck.", "rpn_head.", "roi_head.", "bbox_head.", "mask_head.",
             "semantic_head.")

# mmdet tensors of structures that the JAX heads (and so the port's) lack:
# skipping them would load a checkpoint into another function. A key raises
# where the model lacks it (an ATSS model has the atss_* convs that a PAA
# model lacks).
MMDET_ONLY = {
    r"neck\.(lateral_trans|fpn_transitions|output_transition)\.":
        "mmdet's FPG (its lateral_trans, fpn_transitions and output_transition: the JAX FPG "
        "is a simplified grid, lateral_convs, down_convs, up_convs and out_convs here)",
    r"neck\.upsample_modules\.\d+\.":
        "mmdet's FPN-CARAFE extra P6 path (extra_l_conv on C5 as lateral_convs.4, its CARAFE "
        "as upsample_modules.3, extra_fpn_conv as fpn_convs.4; the JAX FPN_CARAFE max-pools P5 "
        "for P6)",
    r"roi_head\.bbox_head\.\d+\.instance_interactive_conv\.fc_norm\.":
        "Sparse R-CNN's DynamicConv.fc_norm (the JAX DIIHead has no LayerNorm and ReLU "
        "after fc_layer)",
    r"roi_head\.grid_head\.(forder_trans|sorder_trans)\.":
        "Grid R-CNN's feature fusion (the JAX GridHead has none)",
    r"bbox_head\.vfnet_reg_conv\.":
        "VFNet's vfnet_reg_conv, a GN conv before vfnet_reg (the JAX VFNetHead has none)",
    r"bbox_head\.((cls|reg)_convs\.\d+\.gn|scales\.\d+|atss_(cls|reg|centerness))\.":
        "a part of an ATSS head: GN in the towers, scales, atss_* convs (mmdet's PAA head is "
        "an ATSS head; the JAX one is a RetinaHead, with retina_cls, retina_reg and "
        "retina_iou)",
    r"neck\.extra_downsamples\.":
        "NAS-FPN's or NAS-FCOS's convs on the extra levels (the JAX necks max-pool them)",
    r"neck\.fpn_stages\.\d+\.(sum_77_7\.|gp_54_7\.|\w+\.out_conv\.conv\.bias)":
        "a part of mmdet's NAS-FPN stage the JAX one lacks: sum_77_7 and gp_54_7 (JAX merges "
        "P5 and P7 in one cell, gp_55_7) or a cell conv's bias (the JAX cells' convs have "
        "none before their BN)",
    r"neck\.fpn\.":
        "mmdet's NAS-FCOS concat cells (the JAX NASFCOS_FPN merges top-down with sum cells)",
    r"bbox_head\.(cls|reg)_convs\.\d+\.conv\.conv_offset\.":
        "NAS-FCOS's deformable tower convs (the JAX NASFCOSHead's towers are plain 3x3 convs)",
    r"bbox_head\.(tl|br)_pool\.\d+\.conv2\.":
        "the 3x3 conv2 after mmdet's BiCornerPool (the JAX CascadeCornerPool ends at its ReLU)",
    r"bbox_head\.(tl|br)_(guiding_shift|feat_adaption|dcn_offset)\.":
        "CentripetalNet's guiding shifts and deformable feature adaption (the JAX "
        "CentripetalHead has neither)",
    r"backbone\.hourglass_modules\.\d+\.(low2\.)*low3\.[1-9]\d*\.downsample\.":
        "a downsample in a later block of an Hourglass low3 (mmdet's low3 changes its channels "
        "in its last block, the JAX one in its first)",
    r"(mask_head\.protonet|segm_head)\.":
        "YOLACT's protonet and semantic head as mmdet's own mask_head and segm_head (the JAX "
        "YOLACTHead holds a protonet without mmdet's 3x3 conv after the upsample and an "
        "untrained segm_conv: bbox_head.proto_convs, proto_out and segm_conv)",
    r"bbox_head\.transformer\.decoder\.post_norm\.":
        "DETR's decoder post_norm (the JAX Transformer returns its decoder layers' outputs "
        "with no final norm)",
    r"neck\.extra_convs\.":
        "ChannelMapper's extra level for num_outs (the JAX ChannelMapper drops num_outs and "
        "maps its inputs alone: Deformable DETR on 3 levels, not 4)",
    r"neck\.convs\.\d+\.gn\.":
        "a GN in ChannelMapper (the repo's Deformable DETR config names no norm_cfg)",
    r"semantic_head\.conv_upsample_layers\.":
        "mmdet's PanopticFPNHead (the JAX PanopticFPN's semantic head is HTC's "
        "FusedSemanticHead: semantic_head.lateral_convs, convs, conv_embedding, conv_logits)",
    r"neck\.(extra_layers|l2_norm)\.":
        "mmdet's SSDNeck (its L2Norm and extra convs under neck., mmdet 2.18 on; the JAX "
        "SSDVGG holds them as backbone.l2_norm and backbone.extra, mmdet's older layout)",
}


RESNEST_WIDTH = ("mmdet's ResNeSt bottlenecks are planes wide where groups == 1; the JAX "
                 "ResNeSt's (and the port's) int(planes * base_width / 64) * groups, planes / "
                 "16 at base_width 4")


def carafe_mmdet_order(w: torch.Tensor) -> torch.Tensor:
    """A CARAFE ``content_encoder``'s output rows in mmcv's ``pixel_shuffle``
    order (``tap * 4 + sy * 2 + sx``) -> the JAX package's ((``sy * 2 + sx)
    * G * k * k + tap``)."""
    taps = w.shape[0] // 4
    return w[torch.tensor([t * 4 + p for p in range(4) for t in range(taps)])]


def mmdet_state_dict(ckpt) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A loaded checkpoint (its ``state_dict``, or a bare state dict) ->
    (the state dict, whether it is a classification checkpoint's): such a
    checkpoint's keys (none under a detector section) get ``backbone.``,
    its ``fc.`` and ``head.`` dropped."""
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if sd and not any(str(k).startswith(_SECTIONS) for k in sd):
        return {f"backbone.{k}": v for k, v in sd.items()
                if not str(k).startswith(("fc.", "head."))}, True
    return dict(sd), False


def _detr_layout(sd: Dict[str, torch.Tensor], own: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """mmdet's DETR and Deformable DETR tensors in the port's layout: the 1x1
    conv ``input_proj`` as the dense layer it is here; a deformable
    attention's one shared ``value_proj`` copied into each level's
    ``value_proj.{l}`` (the JAX package's, ROADMAP C). A deformable
    attention's sampling offsets or weights for another number of levels
    raise ``ValueError`` naming both counts."""
    sd = dict(sd)
    key = "bbox_head.input_proj.weight"
    if key in sd and key in own and sd[key].dim() == 4 and own[key].dim() == 2:
        sd[key] = sd[key].reshape(sd[key].shape[:2])
    for k in [k for k in sd if re.search(r"\.value_proj\.(weight|bias)$", k)]:
        pre, leaf = k.rsplit(".", 1)
        levels = [f"{pre}.{li}.{leaf}" for li in range(8) if f"{pre}.{li}.{leaf}" in own]
        if levels:
            v = sd.pop(k)
            sd.update({lk: v for lk in levels})
    for k, v in sd.items():
        m = re.search(r"\.(sampling_offsets|attention_weights)\.weight$", k)
        if m and k in own and v.shape != own[k].shape:
            per = 2 if m.group(1) == "sampling_offsets" else 1
            value_levels = sum(1 for o in own if o.startswith(k.rsplit(".", 2)[0] + ".value_proj.")
                               and o.endswith(".weight"))
            rows = own[k].shape[0] // value_levels
            raise ValueError(f"checkpoint tensor {k} has {v.shape[0]} rows, "
                             f"{v.shape[0] // rows} levels of {rows // per} heads x points; "
                             f"the model's has {own[k].shape[0]}, {value_levels} levels (the JAX "
                             "ChannelMapper drops num_outs: Deformable DETR runs on the neck's "
                             "3 levels, mmdet's on 4)")
    return sd


def load_mmdet_checkpoint(model: torch.nn.Module, checkpoint, logger=None
                          ) -> Dict[str, List[str]]:
    """Graft ``checkpoint`` (a file, read with ``torch.load(...,
    weights_only=True)``, or a loaded dict) onto ``model`` in place.

    Returns ``{"loaded": keys, "skipped": ["key (why)", ...], "missing":
    keys}``: ``skipped`` holds ``num_batches_tracked``, ``ema_*`` and keys
    the model lacks, ``missing`` the model's keys that a classification
    checkpoint lacks (they keep their values). A detector checkpoint with
    a key ``missing`` or a key of ``MMDET_ONLY`` raises ``KeyError``, a shape
    mismatch ``ValueError``; each before the model is touched."""
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = torch.load(checkpoint, map_location="cpu", weights_only=True)
    own = model.state_dict()
    take, skipped = {}, []
    sd, backbone_only = mmdet_state_dict(checkpoint)
    for ours, theirs in getattr(getattr(model, "bbox_head", None), "mmdet_names", {}).items():
        mine, other = f"bbox_head.{ours}.", f"bbox_head.{theirs}."      # FSAF's retina_cls
        sd = {mine + k[len(other):] if k.startswith(other) else k: v for k, v in sd.items()}
    if type(getattr(model, "backbone", None)).__name__ == "CSPDarknet" and \
            "backbone.stem.conv.conv.weight" in sd and not backbone_only:
        from ..models.backbones.csp_darknet import focus_mmdet_order
        sd["backbone.stem.conv.conv.weight"] = focus_mmdet_order(sd["backbone.stem.conv.conv.weight"])
    sd = _detr_layout(sd, own)
    if type(getattr(model, "neck", None)).__name__ == "FPN_CARAFE" and not backbone_only:
        sd = {k: carafe_mmdet_order(v) if re.fullmatch(
            r"neck\.upsample_modules\.\d+\.content_encoder\.(weight|bias)", k) and k in own
            else v for k, v in sd.items()}
    if type(getattr(model, "backbone", None)).__name__ == "ResNeSt":
        wide = sorted(k for k, v in sd.items() if k.startswith("backbone.layer") and k in own
                      and tuple(v.shape) != tuple(own[k].shape))
        if wide:
            raise ValueError(f"checkpoint tensor {wide[0]} has shape {tuple(sd[wide[0]].shape)}, "
                             f"the model's {tuple(own[wide[0]].shape)}: {RESNEST_WIDTH}")
    for pattern, what in MMDET_ONLY.items():
        extra = sorted(k for k in sd if re.match(pattern, k) and k not in own)
        if extra:
            raise KeyError(f"the checkpoint holds {what}: {', '.join(extra[:4])}"
                           f"{', ...' if len(extra) > 4 else ''}; the port's head lacks it")
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            skipped.append(f"{k} (num_batches_tracked)")
        elif k.startswith("ema_"):
            skipped.append(f"{k} (EMA buffer)")
        elif k not in own:
            skipped.append(f"{k} (not in the model)")
        elif tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint tensor {k} has shape {tuple(v.shape)}, the model's "
                             f"{tuple(own[k].shape)}")
        else:
            take[k] = v
    missing = sorted(set(own) - set(take))
    if missing and not backbone_only:
        raise KeyError(f"the detector checkpoint lacks {len(missing)} of the model's tensors: "
                       f"{', '.join(missing[:8])}{', ...' if len(missing) > 8 else ''}")
    model.load_state_dict(take, strict=False)
    report = {"loaded": sorted(take), "skipped": skipped, "missing": missing}
    if logger is not None:
        reasons: Dict[str, int] = {}
        for entry in skipped:
            why = entry.rsplit(" (", 1)[1][:-1]
            reasons[why] = reasons.get(why, 0) + 1
        logger.info(f"checkpoint: {len(take)} of the model's {len(own)} tensors loaded; "
                    f"skipped {reasons or 0}; missing {len(report['missing'])}"
                    + (f" ({', '.join(report['missing'][:8])}"
                       f"{', ...' if len(report['missing']) > 8 else ''})"
                       if report["missing"] else ""))
    return report
