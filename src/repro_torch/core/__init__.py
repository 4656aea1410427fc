"""Pivoted QR, QR-LoRA init and the adapter API of the port."""
