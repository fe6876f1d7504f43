"""attention IP family — the LM hot path's attention members: the
materialized oracle, tiled flash attention and single-token decode."""
