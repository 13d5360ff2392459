"""Device and RNG policy (counterpart of ``deeplearning4j_tpu.backend``)."""
