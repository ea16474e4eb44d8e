"""Offline converters that turn published weights into the npz files both
packages read, with numpy and torch only (no JAX):

    python -m gnerf_tpu_torch.tools.convert_reference_pkl --pkl network.pkl \
        --reference /path/to/g_nerf --out gnerf.npz
    python -m gnerf_tpu_torch.tools.convert_vgg16_lpips --pt vgg16.pt --out lpips_vgg16.npz
    python -m gnerf_tpu_torch.tools.convert_inception --pt inception_v3_google.pth \
        --out inception.npz

Each writes what the JAX package's `tools/convert_*.py` of the same name
writes.
"""
