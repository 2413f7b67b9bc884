from .awgn import AWGNChannel, ChannelConfig
