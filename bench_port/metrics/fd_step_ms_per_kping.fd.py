"""The masked chunk step (parallel.pipeline.sharded_mvbs_partials_freqdiff: pageable H2D of the operands, Sv, the mask, the bins, launched): stage freqdiff_step, from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "freqdiff_step")
