"""repro_torch.comm — bucket fusion, wire codecs, the byte ledger, the link
topology models and the per-round accounting."""
from repro_torch.comm.accounting import (LevelCost, RoundCost,
                                         measured_payload_bits,
                                         payload_bits_for, round_bits,
                                         round_cost, round_ledger)
from repro_torch.comm.buckets import (DEFAULT_BUCKET_SIZE, BucketLayout,
                                      bucketize, bucketize_groups,
                                      debucketize, debucketize_groups)
from repro_torch.comm.codecs import (DEFAULT_TILE, Chunk, Payload, PayloadError,
                                     StreamPayload, analytic_bits, decode,
                                     decode_stream, encode, encode_stream,
                                     encoded_bits, extrapolate_bits,
                                     roundtrip_equal, seal_payload,
                                     split_payload, stream_roundtrip_equal,
                                     validate_payload, verify_payload)
from repro_torch.comm.ledger import (BROADCAST_TAG, PAGE_IN_TAG, PAGE_OUT_TAG,
                                     RETRY_TAG, UPLOAD_TAG, WIRE_SCHEME_TAGS,
                                     CommLedger, CommRecord, crosscheck_hlo,
                                     known_tags, register_tag)
from repro_torch.comm.topology import (DEFAULT_PROFILE, DEFAULT_TILE_BYTES,
                                       PRESETS, CodecProfile, Link, Topology,
                                       get_topology, norm_ppf, pipelined_time_s,
                                       ring_parts_s, ring_time_s,
                                       straggler_level_time_s, stream_pipeline_s)
from repro_torch.comm.tree import (TREE_PRESETS, TreeLevel, TreeTopology,
                                   get_tree_topology, register_tree_topology)
