"""IO: capture-file readers and SDR front-end logic (Fc choice, formats)."""
