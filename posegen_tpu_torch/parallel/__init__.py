from posegen_tpu_torch.parallel.mesh import (  # noqa: F401
    auto_render_fn,
    batch_pspecs,
    make_mesh,
    make_parallel_render,
    make_shardmap_render,
    make_shardmap_render_cam,
    make_shardmap_train_step,
    replicate,
    shard_batch,
)
