"""The dataflow engine: delta blocks, operators, the tick scheduler and the
run loop, carried from ``pathway_tpu/engine/``."""
