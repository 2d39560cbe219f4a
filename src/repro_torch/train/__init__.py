"""Training (counterpart of `repro.train`): the chunked loss, AdamW and the
sign-majority optimizer, and the single-GPU train step and Trainer."""
