"""repro_torch.comm — bucket fusion, wire codecs and the byte ledger."""
from repro_torch.comm.buckets import (DEFAULT_BUCKET_SIZE, BucketLayout,
                                      bucketize, bucketize_groups,
                                      debucketize, debucketize_groups)
from repro_torch.comm.codecs import (Payload, PayloadError, decode, encode,
                                     seal_payload, validate_payload,
                                     verify_payload)
from repro_torch.comm.ledger import (BROADCAST_TAG, PAGE_IN_TAG, PAGE_OUT_TAG,
                                     RETRY_TAG, UPLOAD_TAG, WIRE_SCHEME_TAGS,
                                     CommLedger, CommRecord, known_tags,
                                     register_tag)
