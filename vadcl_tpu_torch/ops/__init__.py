from vadcl_tpu_torch.ops.cluster import (
    cdist,
    feature_cluster_assign,
    frobenius_norm,
    neg_soft_assign,
    pos_soft_assign,
    space_cluster_assign,
)
from vadcl_tpu_torch.ops.cluster_kernels import cluster_assign, space_cluster_loss
from vadcl_tpu_torch.ops.convs import (
    conv3d,
    conv_transpose3d,
    max_pool3d_same,
    patchify_matmul,
    same_pad_amounts,
)
from vadcl_tpu_torch.ops.fold_attn import (
    fold_attention,
    fold_attention_bwd,
    fold_attention_bwd_tiles,
    fold_attention_packed,
    fold_block,
    fold_block_bwd,
    fold_block_bwd_tiles,
    fold_block_tiles,
)
from vadcl_tpu_torch.ops.ln_mlp import (
    ln_mlp,
    ln_mlp_bwd,
    ln_mlp_bwd_slab,
    ln_mlp_bwd_tiles,
    ln_mlp_slab,
    ln_mlp_tiles,
)
from vadcl_tpu_torch.ops.memory import memory_losses, memory_read, memory_update
from vadcl_tpu_torch.ops.window_attn import (
    window_attention_fused,
    window_attention_fused_bwd,
    window_attention_fused_bwd_rows,
    window_attention_fused_bwd_tiles,
    window_attention_fused_rows,
    window_attention_fused_tiles,
    window_attention_packed,
    window_attention_packed_rows,
    window_attention_packed_tiles,
)
from vadcl_tpu_torch.ops.window import (
    compute_attn_mask,
    get_window_size,
    relative_position_index,
    window_attention,
    window_partition,
    window_reverse,
)

# The wrappers of the hand-written CUDA kernels, each with a ``launches``
# counter that counts its kernel launches (CPU calls run the plain version
# and do not count): forward kernels A-D, backward kernels 5 and 6, then the
# partitioned-window attention kernels 7, 8 and 9 (whole-tile bodies), then
# kernel 10 (the packed fold attention), the whole-Swin-block kernel each way,
# the row-tiled bodies of 7, 8 and 9 (windows the whole-tile bodies cannot
# hold), the CUDA-core and shared-memory bodies of 5 and 6 (fp32, and the
# bf16 geometries their tensor-core bodies do not take), and kernel B's
# CUDA-core body (fp32, and the bf16 widths its tensor-core body does not
# take), the whole-block backward's shared-memory body (fp32, and the bf16
# geometries its tensor-core body does not take), the whole-block
# forward's older body (the same), and the whole-tile bodies of 7 and 8
# (fp32, and the bf16 geometries kernels A's and 6's tensor-core bodies do
# not take: ``window_attention_fused`` and ``window_attention_fused_bwd``
# count those bodies' launches on windows of at most 112 tokens, 208 at head
# width 16), and the
# whole-tile body of 9 (the same, ``window_attention_packed`` counting A's
# packed body).  A ``base`` or ``packed`` block on the unpartitioned tensor
# (``window_grid_route``) counts its ``fold_attention`` launches on those of
# 7, 9 and 8.  Then kernel B's slab body (bf16 widths above 192, which the
# wgmma body counted on ``ln_mlp`` does not hold), and last kernel 5's slab
# body (its bf16 widths above 192, which the body counted on ``ln_mlp_bwd``
# does not hold).
KERNELS = (fold_attention, ln_mlp, cluster_assign, space_cluster_loss, ln_mlp_bwd,
           fold_attention_bwd, window_attention_fused, window_attention_fused_bwd,
           window_attention_packed, fold_attention_packed, fold_block, fold_block_bwd,
           window_attention_fused_rows, window_attention_fused_bwd_rows,
           window_attention_packed_rows, ln_mlp_bwd_tiles, fold_attention_bwd_tiles,
           ln_mlp_tiles, fold_block_bwd_tiles, fold_block_tiles,
           window_attention_fused_tiles, window_attention_fused_bwd_tiles,
           window_attention_packed_tiles, ln_mlp_slab, ln_mlp_bwd_slab)

__all__ = [
    "KERNELS",
    "cdist",
    "cluster_assign",
    "compute_attn_mask",
    "conv3d",
    "conv_transpose3d",
    "feature_cluster_assign",
    "fold_attention",
    "fold_attention_bwd",
    "fold_attention_bwd_tiles",
    "fold_attention_packed",
    "fold_block",
    "fold_block_bwd",
    "fold_block_bwd_tiles",
    "fold_block_tiles",
    "frobenius_norm",
    "get_window_size",
    "ln_mlp",
    "ln_mlp_bwd",
    "ln_mlp_bwd_slab",
    "ln_mlp_bwd_tiles",
    "ln_mlp_slab",
    "ln_mlp_tiles",
    "max_pool3d_same",
    "memory_losses",
    "memory_read",
    "memory_update",
    "neg_soft_assign",
    "patchify_matmul",
    "pos_soft_assign",
    "relative_position_index",
    "same_pad_amounts",
    "space_cluster_assign",
    "space_cluster_loss",
    "window_attention",
    "window_attention_fused",
    "window_attention_fused_bwd",
    "window_attention_fused_bwd_rows",
    "window_attention_fused_bwd_tiles",
    "window_attention_fused_rows",
    "window_attention_fused_tiles",
    "window_attention_packed",
    "window_attention_packed_rows",
    "window_attention_packed_tiles",
    "window_partition",
    "window_reverse",
]
