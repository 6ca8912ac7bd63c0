from xggm_tpu_torch.ops.noise import (
    add_edge_noise, add_feature_noise, add_gaussian_noise,
    mask_adjs, node_feature_to_matrix, check_adjs_symmetry,
    add_self_loops, remove_self_loops, pad_adjs,
)
from xggm_tpu_torch.ops.losses import (
    bce_with_logits, symmetric_kl, score_matching_loss,
    cross_entropy, smooth_l1, hinge_discriminator_loss,
)
from xggm_tpu_torch.ops.segment import to_dense_batch, segment_sum
