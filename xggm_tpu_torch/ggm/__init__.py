from xggm_tpu_torch.ggm.generators import (
    GCNGenerator, GINGenerator, GATGenerator, EdgeGenerator, NodeGenerator,
    Discriminator, DiscriminatorV2, make_generator,
)
