"""Paper Table 4 epoch-to-convergence counts (CIFAR-10 columns), for the
analytic benchmarks to weight per-epoch costs the way the paper does (the
port's copy of ``repro.benchmarks_epochs``).  Ampere entries are
(device_epochs, server_epochs)."""

EPOCHS_TABLE4 = {
    "mobilenet-l": {"splitfed": 200, "pipar": 210, "scaffold": 240,
                    "splitgp": 300, "ampere": (55, 32)},
    "vgg11": {"splitfed": 115, "pipar": 121, "scaffold": 184,
              "splitgp": 211, "ampere": (61, 25)},
    "swin-t": {"splitfed": 120, "pipar": 152, "scaffold": 216,
               "splitgp": 240, "ampere": (55, 22)},
    "vit-s": {"splitfed": 131, "pipar": 135, "scaffold": 244,
              "splitgp": 201, "ampere": (81, 46)},
}
