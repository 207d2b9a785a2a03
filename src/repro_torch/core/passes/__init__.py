from repro_torch.core.passes import (  # noqa: F401
    backends, caching, folding, fusion, precision, sharding, streaming,
    tiling)


def default_passes():
    """The default pipeline's pass instances, in execution order."""
    from repro_torch.core.passmanager import GraphBuildPass
    return [GraphBuildPass(), fusion.FusionPass(), streaming.StreamingPass(),
            folding.FoldingPass(), sharding.ShardingPass(),
            tiling.TilingPass(), precision.PrecisionPass(),
            caching.CachingPass(), backends.KernelSelectPass()]
