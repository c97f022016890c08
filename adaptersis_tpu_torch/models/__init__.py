"""Backbone, adapters, encoder, decoder and the AdapterSegmentor."""
