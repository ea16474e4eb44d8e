"""Host helpers: checkpoints and the JAX weight bridge, cameras, devices,
the native image loader."""
