"""Distribution of the port: the logical-axis sharding rules
(``sharding``) and the mesh-aware low-bit matmul over ``torch.distributed``
ranks (``qmm_mesh``).  The serving mesh; the training mesh (sharded float
leaves and gradients) comes with a later slice."""
