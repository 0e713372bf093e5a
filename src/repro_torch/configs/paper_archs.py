"""The paper's own evaluation architectures (Ampere §5.1).

CIFAR-scale classifiers: MobileNetV3-Large-style inverted-residual CNN,
VGG-11, ViT-Small and a Swin-Tiny-style windowed ViT.  These drive the
faithful reproduction path (Figures 3/6/7/8/10/11, Tables 1/2/4/5).
"""

from repro_torch.configs.base import VisionConfig

MOBILENET_L = VisionConfig(
    name="mobilenet-l",
    family="cnn",
    num_classes=10,
    img_size=32,
    stem_channels=16,
    # 15 inverted-residual stages ~ MobileNetV3-Large block channels
    block_channels=(16, 24, 24, 40, 40, 40, 80, 80, 80, 80, 112, 112, 160, 160, 160),
    block_strides=(1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1),
    expand_ratio=4,
    use_se=True,
)

MOBILENET_L_SMOKE = VisionConfig(
    name="mobilenet-l-smoke",
    family="cnn",
    num_classes=10,
    img_size=16,
    stem_channels=8,
    block_channels=(8, 12, 16),
    block_strides=(1, 2, 2),
    expand_ratio=2,
    use_se=True,
)

VGG11 = VisionConfig(
    name="vgg11",
    family="vgg",
    num_classes=10,
    img_size=32,
    block_channels=(64, 128, 256, 256, 512, 512, 512, 512),
    block_strides=(1, 2, 2, 1, 2, 1, 2, 1),
)

VGG11_SMOKE = VisionConfig(
    name="vgg11-smoke",
    family="vgg",
    num_classes=10,
    img_size=16,
    block_channels=(8, 16, 16),
    block_strides=(1, 2, 2),
)

VIT_S = VisionConfig(
    name="vit-s",
    family="vit",
    num_classes=10,
    img_size=32,
    patch_size=4,
    depth=12,
    d_model=384,
    num_heads=6,
    mlp_ratio=4.0,
)

VIT_S_SMOKE = VisionConfig(
    name="vit-s-smoke",
    family="vit",
    num_classes=10,
    img_size=16,
    patch_size=4,
    depth=2,
    d_model=48,
    num_heads=4,
    mlp_ratio=2.0,
)

SWIN_T = VisionConfig(
    name="swin-t",
    family="swin",
    num_classes=10,
    img_size=32,
    patch_size=4,
    depth=12,
    d_model=96,
    num_heads=4,
    mlp_ratio=4.0,
    window_size=4,
)

SWIN_T_SMOKE = VisionConfig(
    name="swin-t-smoke",
    family="swin",
    num_classes=10,
    img_size=16,
    patch_size=4,
    depth=2,
    d_model=32,
    num_heads=2,
    mlp_ratio=2.0,
    window_size=2,
)
