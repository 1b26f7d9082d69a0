"""Functional NN layers shared by the pose GAN and HMR (port of posegen_tpu/nn/)."""
