"""The pose GAN, HMR / SPIN and the feedback loop (port of posegen_tpu/gen/)."""
