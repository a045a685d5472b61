"""Coded link simulation: QPSK, the 802.11n LDPC code and its min-sum
decoder, MIMO soft demappers, and the BER/BLER sweep (`link` command)."""

from .ldpc import LDPCCode, make_wifi_ldpc, make_wifi_like_ldpc, minsum_decode  # noqa: F401
from .link import LinkResults, run_link_simulation  # noqa: F401
from .mimo import mimo_ml_llr  # noqa: F401
from .modulation import qpsk_demap_llr, qpsk_modulate  # noqa: F401
