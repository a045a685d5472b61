"""Channel files and the channel dataset."""

from .dataset import ChannelDataset, channel_filename

__all__ = ["ChannelDataset", "channel_filename"]
