"""Small shared utilities (mimm_tpu/utils.py:12-31 counterpart).

``MimicID`` keeps the reference's composite-id contract
(``mutual_info_img_txt/utils.py:3-18``): ids look like
``p<subject>_s<study>_<dicom>`` and ``get_study_id`` extracts the study.
"""

from __future__ import annotations


class MimicID:
    """Composite MIMIC-CXR identifier ``p<subject>_s<study>_<dicom>``."""

    def __init__(self, subject_id, study_id, dicom_id):
        self.subject_id = str(subject_id)
        self.study_id = str(study_id)
        self.dicom_id = str(dicom_id)

    def __str__(self) -> str:
        return f"p{self.subject_id}_s{self.study_id}_{self.dicom_id}"

    @staticmethod
    def get_study_id(mimic_id: str) -> str:
        """'p123_s456_abc' -> '456'."""
        return mimic_id.split("_")[1][1:]

    @staticmethod
    def get_subject_id(mimic_id: str) -> str:
        """'p123_s456_abc' -> '123'."""
        return mimic_id.split("_")[0][1:]
