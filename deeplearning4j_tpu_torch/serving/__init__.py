"""Serving pieces the port needs (counterpart of ``deeplearning4j_tpu.serving``)."""
