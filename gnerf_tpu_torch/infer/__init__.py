"""Inference: the orbit-video entry point and its video writer."""
