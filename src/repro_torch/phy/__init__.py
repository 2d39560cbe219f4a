"""PHY channel tiers of the OTA serve (see `repro_torch.phy.channel`)."""
from repro_torch.phy.channel import (
    CHANNELS,
    BSCChannel,
    Channel,
    ChannelState,
    IdealChannel,
    combo_index,
    get_channel,
    register_channel,
    state_from_ber,
    state_from_ota,
)

__all__ = [
    "CHANNELS",
    "BSCChannel",
    "Channel",
    "ChannelState",
    "IdealChannel",
    "combo_index",
    "get_channel",
    "register_channel",
    "state_from_ber",
    "state_from_ota",
]
