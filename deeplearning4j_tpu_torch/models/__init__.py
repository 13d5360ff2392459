"""Model facades (counterpart of ``deeplearning4j_tpu.models``)."""
