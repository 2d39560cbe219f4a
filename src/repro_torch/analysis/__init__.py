"""What a step costs, counted without running it (counterpart of
`repro/analysis`): `roofline` holds the H100's peaks, the roofline terms and
the model-FLOPs yardstick; `op_cost` counts a traced call's FLOPs, bytes,
live memory, kernel work and wire bytes on fake tensors."""
