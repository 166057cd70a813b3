"""Data parallelism, multi-host runs and the patch-grid-sharded corrector
(counterpart of ``contrast_gan_3d_tpu/parallel``)."""
