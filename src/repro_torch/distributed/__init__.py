from repro_torch.distributed.collectives import ota_noise, ota_noise_packed  # noqa: F401
