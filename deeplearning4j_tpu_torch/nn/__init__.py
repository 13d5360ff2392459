"""Config, layers and their building blocks (counterpart of ``deeplearning4j_tpu.nn``)."""
