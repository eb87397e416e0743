# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The paper's own testbed models (Section VII.A): LeNet / AlexNet / ResNet-18."""
from repro_torch.configs.base import ModelConfig

LENET = ModelConfig(
    name="lenet", family="cnn",
    image_size=28, in_channels=1, num_classes=10,
    cnn_channels=(6, 16),          # conv stages; then 120-84-10 dense head
)

ALEXNET = ModelConfig(
    name="alexnet", family="cnn",
    image_size=32, in_channels=3, num_classes=10,
    cnn_channels=(64, 192, 384, 256, 256),   # CIFAR-scale AlexNet
)

RESNET18 = ModelConfig(
    name="resnet18", family="cnn",
    image_size=32, in_channels=3, num_classes=100,
    cnn_channels=(64, 128, 256, 512),        # stage widths, 2 blocks each
)

CNNS = {c.name: c for c in (LENET, ALEXNET, RESNET18)}
