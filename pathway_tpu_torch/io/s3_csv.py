"""S3 CSV reader (reference ``python/pathway/io/s3_csv/__init__.py``: the
legacy ``pw.io.s3_csv.read`` alias of ``pw.io.s3.read(format="csv")``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io.s3 import AwsS3Settings, read as _s3_read


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: Any | None = None,
    mode: str = "streaming",
    csv_settings=None,
    **kwargs,
):
    return _s3_read(
        path,
        aws_s3_settings=aws_s3_settings,
        format="csv",
        schema=schema,
        mode=mode,
        csv_settings=csv_settings,
        **kwargs,
    )
