"""VLM prompt builder for inpainting and outpainting enrichment.

Port of ``flux2_tpu/chains/vlm_prompt.py`` (its strings copied, held against
the originals by ``tests/test_torch_shared_copies.py``). FLUX.2 has no
negative prompt and no edit channel, so the masked region's only steering
signal is the text prompt, whose right shape depends on the edit intent.
Each intent maps to a system prompt that has a VLM extract the source's
photographic identity (camera angle, lighting, materials, palette, depth of
field) and write one 30-80 word prompt (Subject + Action + Style + Context):

- replace: the NEW subject inheriting the scene's identity, never naming the
  removed object;
- remove: only the surface continuing under the removal;
- modify: the subject kept recognisable, the change as the Action;
- change_scene: the mask inverted, the subject kept verbatim and the NEW
  scene around it described.

With no VLM attached the builder returns ``None`` and callers keep the
user's prompt; a VLM call that raises returns ``None`` too (JAX's
semantics: the chain never breaks on its optional enrichment).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence


class InpaintIntent(enum.Enum):
    REPLACE = "replace"
    REMOVE = "remove"
    MODIFY = "modify"
    CHANGE_SCENE = "change_scene"


_IDENTITY_CLAUSE = (
    "First extract the source image's photographic identity: camera angle and "
    "focal feel, lighting direction and color temperature, materials and "
    "surface textures, color palette, and depth of field."
)

_OUTPUT_CLAUSE = (
    "Then output exactly ONE image-generation prompt of 30-80 words using the "
    "structure Subject + Action + Style + Context, leading with the most "
    "important words. Never use negations — state only what should be present. "
    "Output the prompt text alone, nothing else."
)

SYSTEM_PROMPTS = {
    InpaintIntent.REPLACE: (
        "You are a prompt engineer for an image inpainting model. The user "
        "will replace the masked object with a NEW subject they name. "
        f"{_IDENTITY_CLAUSE} Describe the new subject so it inherits that "
        "identity — matching perspective, a cast shadow consistent with the "
        "existing light direction, matching palette and grain. NEVER mention "
        "the object being removed: naming it re-introduces it. "
        f"{_OUTPUT_CLAUSE}"
    ),
    InpaintIntent.REMOVE: (
        "You are a prompt engineer for an image inpainting model. The user "
        "wants the masked object GONE, with the surrounding surface "
        "continuing seamlessly through the gap. Look only at the pixels "
        "around the masked region and describe that surface alone — its "
        "material, texture, color, and how the light falls on it. NEVER "
        "mention or allude to the removed object in any way. "
        f"{_OUTPUT_CLAUSE}"
    ),
    InpaintIntent.MODIFY: (
        "You are a prompt engineer for an image inpainting model. The user "
        "wants to modify the existing masked subject in place (color, "
        "clothing, expression, material) while keeping it recognisable. "
        f"{_IDENTITY_CLAUSE} Describe the SAME subject with the user's "
        "modification applied as the Action, preserving identity, pose, and "
        "integration with the scene. "
        f"{_OUTPUT_CLAUSE}"
    ),
    InpaintIntent.CHANGE_SCENE: (
        "You are a prompt engineer for an image inpainting model. The mask "
        "is INVERTED: the subject is preserved bit-exact and the inpainted "
        "region is the scene AROUND it. Describe the user's new scene so it "
        "integrates with the kept subject: inherit the subject's lighting "
        "direction and color temperature, keep the camera angle, and never "
        "alter or re-describe the subject itself. "
        f"{_OUTPUT_CLAUSE}"
    ),
}

OUTPAINT_SYSTEM_PROMPT = (
    "You are a prompt engineer for an image outpainting model. The source "
    "image will be extended with new strips on the sides listed by the user. "
    f"{_IDENTITY_CLAUSE} Write a prompt describing the FULL extended scene — "
    "mention the kept content too — so the model continues the source's "
    "materials, perspective lines, lighting direction, and palette into the "
    f"new strips. {_OUTPUT_CLAUSE}"
)


@dataclasses.dataclass
class VLMPromptBuilder:
    """Builds enriched prompts via an attached vision-language model.

    ``vlm_chat`` is any callable ``(system: str, user: str, image) -> str``;
    when ``None`` the builder returns None and callers fall back.
    """

    vlm_chat: Optional[Callable] = None

    @property
    def is_loaded(self) -> bool:
        return self.vlm_chat is not None

    def build_inpaint_prompt(self, intent: InpaintIntent, user_prompt: str, image) -> Optional[str]:
        if self.vlm_chat is None:
            return None
        try:
            out = self.vlm_chat(SYSTEM_PROMPTS[intent], user_prompt, image)
            return out.strip() or None
        except Exception:
            return None  # graceful fallback (never break the chain)

    def build_outpaint_prompt(self, user_prompt: str, image, sides: Sequence[str]) -> Optional[str]:
        if self.vlm_chat is None:
            return None
        user = f"Sides being extended: {', '.join(sorted(sides))}. Scene request: {user_prompt}"
        try:
            out = self.vlm_chat(OUTPAINT_SYSTEM_PROMPT, user, image)
            return out.strip() or None
        except Exception:
            return None
