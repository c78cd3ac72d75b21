"""The "render hardware interface" — the zenith-rhi analog.

Re-export surface mirroring zenith-rhi/src/lib.rs:28-67. Where the reference
deliberately leaks `ash::vk` (lib.rs:31), this layer's "native" vocabulary is
jax: resources expose their `jax.Array`s directly, and upper layers may use
jnp freely — the abstraction is deliberately leaky in the same way.
"""

from zenith.rhi.command import (
    CommandEncoder,
    CommandPool,
    DeferReleaseQueue,
    ImmediateCommandEncoder,
    LastFreedStats,
    UploadPool,
)
from zenith.rhi.derive import float1, vec2, vec3, vec4, vertex_layout
from zenith.rhi.device import (
    NUM_BACK_BUFFERS,
    FrameStats,
    PhysicalDevice,
    RenderDevice,
    RhiCore,
    select_physical_device,
)
from zenith.rhi.formats import (
    Format,
    FormatAspect,
    decode_stored,
    encode_present,
    linear_to_srgb,
    srgb_to_linear,
)
from zenith.rhi.pipeline import (
    GraphicPipeline,
    GraphicPipelineDesc,
    GraphicShaderInput,
    PipelineCache,
    PipelineCacheStats,
)
from zenith.rhi.resource import (
    Buffer,
    BufferDesc,
    BufferUsage,
    ResourceCache,
    ResourceCacheStats,
    Texture,
    TextureDesc,
    TextureUsage,
)
from zenith.rhi.sampler import (
    AddressMode,
    BorderColor,
    Filter,
    MipmapMode,
    Sampler,
    SamplerConfig,
)
from zenith.rhi.shader import (
    BindingError,
    BindingKind,
    BoundResources,
    FragmentBuiltins,
    Shader,
    ShaderBinding,
    ShaderReflection,
    ShaderStage,
    VertexInput,
    attr,
    push_constant,
    sampler,
    storage,
    texture2d,
    uniform,
)
from zenith.rhi.state import (
    BlendFactor,
    BlendOp,
    ColorAttachmentDesc,
    ColorBlendState,
    CompareOp,
    CullMode,
    DepthStencilDesc,
    FrontFace,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    InputAssemblyState,
    LoadOp,
    MultisampleState,
    PolygonMode,
    PrimitiveTopology,
    RasterizationState,
    StoreOp,
    VertexAttribute,
    VertexLayout,
)
from zenith.rhi.swapchain import PresentMode, Swapchain, SwapchainConfig

__all__ = [name for name in dir() if not name.startswith("_")]
