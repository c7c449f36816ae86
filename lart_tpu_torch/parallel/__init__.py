"""Several ranks, one GPU each: budgets, photon ids, RNG streams, the
per-chunk tally all-reduce and the drain's deal across ranks
(counterpart of lart_tpu/parallel/)."""
