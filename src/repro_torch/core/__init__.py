"""The paper's system: HDC algebra, EM channel, OTA constellation, classifier
and the scale-out serve (counterparts of `repro/core/*`)."""
